"""Prefetching input pipeline with Eq. 1 time accounting.

    T_total = T_pre + (T_load + T_comp − T_overlap) · #Epochs      (paper Eq. 1)

Background threads read + decode batches (T_load) while the device
computes (T_comp); the overlap is measured, not assumed, so the DNN-side
claim of §4.3 ("loading hides behind compute") is empirically checkable.

Multi-producer mode (``num_producers > 1``) drives the coalesced record
store from several GIL-releasing reader threads at once — host-side I/O
queue depth — while the consumer reassembles batches **in order** through
a bounded sequence window, so batch order (and therefore training
reproducibility) is identical to single-producer mode.  Accounting stays
correct under concurrency: ``t_load`` aggregates producer busy time across
threads (it can exceed wall clock, exactly like aggregate device queue
time), while ``effective_epoch_time`` is measured purely on the consumer
side and remains wall-accurate.

The pipeline is storage-agnostic: LIRS shufflers drive random reads into a
RecordStore, BMF/TFIP drive sequential reads, and the same accounting
applies to both.  ``recycle_fn`` (e.g. ``BatchBufferRing.recycle`` or
``RaggedBufferRing.recycle``) is called with each *fetched* item once the
consumer has moved past it, enabling zero-allocation steady state with
reused destination buffers.  Items can be anything — dense ``(B, R)``
arrays from ``read_batch_into`` or ragged arena triples
(:class:`~repro_torch.storage.record_store.RaggedBatch`) from
``read_batch_ragged`` — the multi-producer ordered reassembly and the
recycle contract are identical for both; :func:`store_fetch_fn` builds
the matching fetch function for a store.
"""
from __future__ import annotations

import queue
import threading
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import numpy as np

from repro_torch.obs import trace as _trace
from repro_torch.storage.record_store import PAGE, RecordStore


@dataclass
class PipelineStats:
    t_load: float = 0.0      # producer busy time (read+decode), summed over threads
    t_comp: float = 0.0      # wall time the consumer spent computing
    t_wait: float = 0.0      # consumer time blocked on the queue (= unhidden load)
    t_preprocess: float = 0.0
    batches: int = 0
    producers: int = 1       # producer threads of the last epoch run
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add_load(self, dt: float):
        """Thread-safe t_load accumulation (called from producer threads)."""
        with self._lock:
            self.t_load += dt

    @property
    def t_overlap(self) -> float:
        """Load time hidden behind compute (= load that never blocked us)."""
        return max(0.0, self.t_load - self.t_wait)

    def effective_epoch_time(self) -> float:
        """T_load + T_comp − T_overlap (Eq. 1) == T_comp + unhidden load.

        Measured entirely on the consumer side, so it stays wall-accurate
        for any number of producer threads."""
        return self.t_comp + self.t_wait


def _attach_context(e: BaseException, epoch: int, seq: int, producer: int):
    """Structured error context for a producer-thread failure.

    The pipeline re-raises the *original* exception exactly once in the
    consumer's thread (type preserved — callers match on it), annotated
    with where in the stream it happened: ``e.pipeline_context`` always,
    and the message string too when the exception carries a plain string
    arg (``OSError(errno, msg)`` styles keep their args untouched)."""
    ctx = {"epoch": epoch, "batch_seq": seq, "producer": producer}
    if getattr(e, "pipeline_context", None) is None:
        e.pipeline_context = ctx
        if len(e.args) == 1 and isinstance(e.args[0], str):
            e.args = (
                f"{e.args[0]} [pipeline: epoch={epoch} "
                f"batch={seq} producer={producer}]",
            )
    return e


class InputPipeline:
    def __init__(
        self,
        batch_iter_fn: Callable[[int], Iterator[np.ndarray]],
        fetch_fn: Callable[[np.ndarray], Any],
        prefetch: int = 2,
        put_fn: Optional[Callable[[Any], Any]] = None,
        num_producers: int = 1,
        recycle_fn: Optional[Callable[[Any], Any]] = None,
    ):
        """batch_iter_fn(epoch) yields index arrays; fetch_fn reads+decodes
        them (host); put_fn optionally ships to device (e.g. sharded
        tensor.to(device)); recycle_fn gets the raw fetched item back once the
        consumer has advanced past it (buffer-ring reuse)."""
        self.batch_iter_fn = batch_iter_fn
        self.fetch_fn = fetch_fn
        self.put_fn = put_fn
        self.prefetch = prefetch
        self.num_producers = max(1, num_producers)
        self.recycle_fn = recycle_fn
        self.stats = PipelineStats()

    # ------------------------------------------------------------ consume
    def _emit(self, raw: Any) -> Iterator[Any]:
        item = self.put_fn(raw) if self.put_fn is not None else raw
        self.stats.batches += 1
        with _trace.timed("pipeline/step", "pipeline") as sp:
            yield item
        self.stats.t_comp += sp.duration_s
        if self.recycle_fn is not None:
            self.recycle_fn(raw)

    def epoch(self, epoch: int) -> Iterator[Any]:
        self.stats.producers = self.num_producers
        if self.num_producers == 1:
            yield from self._epoch_single(epoch)
        else:
            yield from self._epoch_multi(epoch)

    # --------------------------------------------------- single producer
    def _epoch_single(self, epoch: int) -> Iterator[Any]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        DONE = object()
        err: list = []
        stop = threading.Event()

        def producer():
            seq = -1
            try:
                for seq, idx in enumerate(self.batch_iter_fn(epoch)):
                    with _trace.timed("pipeline/fetch", "pipeline") as sp:
                        data = self.fetch_fn(idx)
                    self.stats.add_load(sp.duration_s)
                    if not _put_until(q, data, stop):
                        return
            except Exception as e:  # pragma: no cover - surfaced to consumer
                err.append(_attach_context(e, epoch, seq, 0))
            finally:
                _put_until(q, DONE, stop)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                with _trace.timed("pipeline/wait", "pipeline") as sp:
                    item = q.get()
                self.stats.t_wait += sp.duration_s
                if item is DONE:
                    break
                yield from self._emit(item)
        finally:
            # join even when the consumer abandons the epoch: the producer
            # must quiesce (it exits within one fetch + the 0.1 s put
            # poll once `stop` is set) before the store can be closed
            stop.set()
            th.join()
            # recycle items the consumer never saw (producer death, early
            # abandon) so a buffer ring doesn't leak its slots
            self._drain_queue(q, DONE, wrapped=False)
        if err:
            raise err[0]

    # ---------------------------------------------------- multi producer
    def _epoch_multi(self, epoch: int) -> Iterator[Any]:
        """N producers pull (seq, indices) work items from one shared
        iterator and push (seq, batch) results; the consumer reassembles
        the original order.  A credit window of ``prefetch + producers``
        outstanding sequences bounds memory: a producer may not *start*
        fetching a sequence further ahead than that, so the reorder buffer
        and queue are both bounded even under pathological fetch skew."""
        n_prod = self.num_producers
        window = self.prefetch + n_prod
        q: "queue.Queue" = queue.Queue(maxsize=window)
        DONE = object()
        err: list = []
        stop = threading.Event()
        src = enumerate(self.batch_iter_fn(epoch))
        src_lock = threading.Lock()
        credit = threading.Condition()
        emitted = [0]  # == next sequence the consumer will yield

        def producer():
            seq = -1
            try:
                while not (stop.is_set() or err):
                    with src_lock:
                        try:
                            seq, idx = next(src)
                        except StopIteration:
                            break
                    with credit:
                        while (
                            seq - emitted[0] >= window
                            and not stop.is_set()
                            and not err
                        ):
                            credit.wait(0.1)
                    if stop.is_set() or err:
                        break
                    with _trace.timed("pipeline/fetch", "pipeline") as sp:
                        data = self.fetch_fn(idx)
                    self.stats.add_load(sp.duration_s)
                    if not _put_until(q, (seq, data), stop):
                        return
            except Exception as e:
                err.append(
                    _attach_context(
                        e, epoch, seq, threads.index(threading.current_thread())
                    )
                )
            finally:
                _put_until(q, DONE, stop)

        threads = [
            threading.Thread(target=producer, daemon=True) for _ in range(n_prod)
        ]
        for th in threads:
            th.start()
        pending: dict = {}
        done = 0
        try:
            while done < n_prod:
                if emitted[0] in pending:
                    raw = pending.pop(emitted[0])
                else:
                    with _trace.timed("pipeline/wait", "pipeline") as sp:
                        got = q.get()
                    self.stats.t_wait += sp.duration_s
                    if got is DONE:
                        done += 1
                        continue
                    seq, data = got
                    if seq != emitted[0]:
                        pending[seq] = data
                        continue
                    raw = data
                yield from self._emit(raw)
                with credit:
                    emitted[0] += 1
                    credit.notify_all()
            # producers finished; drain whatever reassembly still holds
            while emitted[0] in pending:
                raw = pending.pop(emitted[0])
                yield from self._emit(raw)
                with credit:
                    emitted[0] += 1
                    credit.notify_all()
        finally:
            # as in the single-producer path: wake + join all producers
            # before returning control, so no reader thread can touch the
            # store after the epoch is over (even on early abandon)
            stop.set()
            with credit:
                credit.notify_all()
            for th in threads:
                th.join()
            # recycle undelivered items (queue + reorder buffer) so a
            # buffer ring survives producer death with all slots free
            self._drain_queue(q, DONE, wrapped=True)
            if self.recycle_fn is not None:
                for data in pending.values():
                    self.recycle_fn(data)
                pending.clear()
        if err:
            raise err[0]

    def _drain_queue(self, q: "queue.Queue", done_sentinel, wrapped: bool):
        """Empty ``q`` after the producers quiesced, recycling every data
        item left behind (``wrapped`` = items are ``(seq, data)`` pairs).
        Without this, each producer death or abandoned epoch strands the
        in-flight batches' ring slots forever."""
        if self.recycle_fn is None:
            return
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                return
            if item is done_sentinel:
                continue
            self.recycle_fn(item[1] if wrapped else item)


def store_fetch_fn(
    store: RecordStore,
    *,
    mode: str = "auto",
    ring: Optional[Any] = None,
    gap_bytes: int = PAGE,
    workers: int = 1,
    shuffler: Any = None,
    cache_budget_bytes: int = 0,
    lookahead: int = 8,
    prefetch_background: bool = True,
    max_epochs: Optional[int] = None,
    eviction_policy: str = "lru",
    prefetch_planner: Optional[bool] = None,
    remote: Any = None,
    placement: Any = None,
) -> Callable[[np.ndarray], Any]:
    """Deprecated shim over :func:`repro_torch.core.readpath.build_data_plane`.

    The fifteen keywords accreted here are now one frozen
    :class:`~repro_torch.core.readpath.ReadPathConfig`; this wrapper builds the
    equivalent config and delegates, so behaviour and batch bytes are
    identical (the byte-identity matrix in ``tests/test_serve.py`` holds
    it to that).  New callers should write::

        from repro_torch.core import ReadPathConfig, build_data_plane
        plane = build_data_plane(store, ReadPathConfig(mode=..., ...))
    """
    from repro_torch.core.readpath import ReadPathConfig, build_data_plane

    config = ReadPathConfig(
        mode=mode,
        ring=ring,
        gap_bytes=gap_bytes,
        workers=workers,
        shuffler=shuffler,
        cache_budget_bytes=cache_budget_bytes,
        lookahead=lookahead,
        prefetch_background=prefetch_background,
        max_epochs=max_epochs,
        eviction_policy=eviction_policy,
        prefetch_planner=prefetch_planner,
        remote=remote,
        placement=placement,
    )
    warnings.warn(
        "store_fetch_fn(**kwargs) is deprecated; use "
        "repro_torch.core.build_data_plane(store, repro_torch.core.ReadPathConfig(...)) "
        "instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return build_data_plane(store, config)


def _put_until(q: "queue.Queue", item: Any, stop: threading.Event) -> bool:
    """Bounded put that aborts when the consumer abandoned the epoch."""
    while True:
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            if stop.is_set():
                return False
