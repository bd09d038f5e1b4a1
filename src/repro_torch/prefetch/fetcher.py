"""Prefetching fetch function: the tiered read path's runtime glue.

``PrefetchingFetcher`` is a drop-in for
:func:`repro_torch.core.pipeline.store_fetch_fn`: call it with a batch's index
array and it returns exactly what the plain fetcher would — a dense
``(B, record_size)`` uint8 buffer or a
:class:`~repro_torch.storage.record_store.RaggedBatch` arena triple — except
that records resident in the DRAM tier are gathered from memory and only
the misses touch storage.  Batch bytes are **identical** with prefetch
on or off (the cache holds exact payload bytes and the output packing
rule is unchanged), for any pipeline producer count, so training
reproducibility is preserved by construction.

A background daemon thread executes the
:class:`~repro_torch.prefetch.scheduler.LookaheadScheduler`'s plans with the
record store's coalesced ragged reader — sharing the store's
GIL-releasing pread pool (``workers``) — so future batches stream into
the cache while the trainer consumes the current one.  Demand misses
(prefetch lagging, cold start) fall through to a direct coalesced read
and fill the cache on the way out; the cache's insert idempotency makes
the demand/prefetch race harmless.

With the policy-aware **planner** on (default for a Belady tier), every
cache insert is admission-filtered: the demand path prices each served
record at its *next-epoch* use position (``scheduler.next_use_after``)
so the cache only retains records that beat a resident's reuse, and the
prefetch worker re-probes admission (``cache.admit``) immediately
before issuing its read, dropping records the cache would decline —
records the planner skipped are *expected misses* on the demand side:
they were never in flight, the plan-completion event still fires for
the batch, and the ordinary miss path reads them exactly once.

Accounting: demand-time DRAM-served records are counted in
``store.stats.cache_hits`` / ``cache_hit_bytes`` (so ``records_per_io``
keeps meaning "storage records per storage I/O"), while the scheduler's
admission-time ``window_hits`` measure the storage reads the tier
*avoided* — the number `IOPlan.cache_hit_fraction` models.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.prefetch.cache import NEVER, TieredCache, copy_records
from repro_torch.prefetch.scheduler import LookaheadScheduler, batch_key
from repro_torch.storage.record_store import (
    PAGE,
    RaggedBatch,
    RecordStore,
    alloc_ragged,
)

_STOP = object()


class PrefetchingFetcher:
    """Tiered-cache fetch function over a record store + shuffler.

    Use as ``InputPipeline(batch_iter_fn=f.batch_iter, fetch_fn=f)`` —
    ``batch_iter`` re-syncs the lookahead window at epoch boundaries (and
    is a pass-through otherwise), while ``__call__`` serves batches.
    Calling the fetcher directly (without ``batch_iter``) also works as
    long as batches arrive in stream order, which is what the pipeline's
    shared ordered iterator guarantees.
    """

    def __init__(
        self,
        store: RecordStore,
        shuffler,
        *,
        budget_bytes: int = 0,
        lookahead: int = 8,
        mode: str = "auto",
        ring=None,
        gap_bytes: int = PAGE,
        workers: int = 1,
        background: bool = True,
        start_epoch: int = 0,
        max_epochs: Optional[int] = None,
        cache: Optional[TieredCache] = None,
        policy: str = "lru",
        planner: Optional[bool] = None,
        remote=None,
        placement=None,
    ):
        if mode == "auto":
            mode = "ragged" if store.variable else "dense"
        if mode not in ("dense", "ragged"):
            raise ValueError(f"mode must be auto|dense|ragged, got {mode!r}")
        if mode == "dense" and store.variable:
            raise ValueError("dense mode needs a fixed-size store")
        self.store = store
        self.shuffler = shuffler
        self.mode = mode
        self.ring = ring
        self.gap_bytes = gap_bytes
        self.workers = workers
        self.background = background
        self.cache = (
            cache
            if cache is not None
            else TieredCache(store.lengths(), budget_bytes, policy=policy)
        )
        # cross-host tier (a RemoteTier of the multi-host tier, not in the
        # port yet: build_data_plane refuses one): when set, cache misses
        # whose predicted holder is a peer host are fetched host-to-host
        # before any storage read — prefetch-side in _execute (overlapped
        # with compute), demand-side in the serve paths (the fallback when
        # prefetch lagged)
        self.remote = remote
        self.scheduler = LookaheadScheduler(
            shuffler,
            self.cache,
            lookahead=lookahead,
            start_epoch=start_epoch,
            max_epochs=max_epochs,
            planner=planner,
            placement=placement,
        )
        self.planner = self.scheduler.planner
        self._sched_lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        # in-flight plan completion events, keyed by batch fingerprint:
        # the demand path *waits* for its batch's outstanding prefetch
        # instead of duplicating the read (without this, a compute-free
        # consumer races the worker batch-for-batch and every record is
        # read twice)
        self._plan_done: dict = {}
        self._closed = False
        self.prefetch_batches = 0   # plans executed with a storage read
        self.prefetch_records = 0   # records brought in by prefetch reads
        # records a plan sourced from a peer host instead of storage, and
        # demand-time misses the cross-host tier served
        self.prefetch_remote_records = 0
        self.demand_remote_records = 0
        # peer-routed plan-time misses handed to the demand path instead
        # of storage (the holder hadn't consumed them yet — epoch-edge
        # window race; see _execute_impl)
        self.peer_deferred = 0
        # window staging (placement-routed belady tiers): plan records
        # with no retention merit on this host are read into a
        # batch-lifetime side buffer instead of the cache, so the pinned
        # prefetch window never squeezes placement-predicted retention
        # out of the tier.  Keyed by batch fingerprint; entries are
        # popped at serve.  The bytes live *outside* the cache budget —
        # the separate window slice ``IOPlan.prefetch_window_bytes``
        # models — and are bounded by the scheduler's pin limit
        # (``capacity // 2`` records, i.e. at most half the budget).
        self._staged: dict = {}
        self._stage_lock = threading.Lock()
        self.staged_records = 0   # records served from the staging buffer
        # consumer-side retention (placement-routed belady tier): after a
        # batch is served, each consumed record's bytes are *pushed* to
        # its placement-predicted next-epoch holder — a peer's inbox via
        # the transport, or this host's own.  The receiver banks pushes
        # here and drains them into its cache between batches (after the
        # previous batch retired, so departures always precede arrivals
        # and the feasible occupancy trajectory is preserved).  Entries
        # that the cache declines (transient within-step squeeze) are
        # requeued and retried at the next drain.
        self._push_on = self.scheduler._stage_floor and remote is not None
        if not self._push_on:
            # staging and push-retention are one mechanism: without a
            # transport to carry the handoff, fall back to plan-time
            # admission-filtered inserts (the single-host belady path)
            self.scheduler._stage_floor = False
        self._inbox: list = []
        self._inbox_lock = threading.Lock()
        self.pushed_records = 0   # records handed to a next-epoch holder
        self.push_errors = 0      # push attempts that raised (peer down)
        # records the pre-read admission probe trimmed from in-flight
        # plans (state drifted since plan time); their final — and only
        # counted — admission decision happens at the demand insert
        self.probe_skips = 0
        self.probe_skip_bytes = 0
        self.last_error: Optional[BaseException] = None
        self.plans_failed = 0     # plans whose execution raised
        self.worker_restarts = 0  # background thread respawns after a crash
        self.plan_waits_timed_out = 0  # demand waits that hit the valve
        # demand-wait safety valve (seconds); configurable mostly for tests
        self.plan_wait_s = 60.0

    # --------------------------------------------------------- scheduling
    def batch_iter(self, epoch: int) -> Iterator[np.ndarray]:
        """Drop-in ``batch_iter_fn``: re-syncs the lookahead window to
        ``(epoch, 0)`` then yields the shuffler's batches unchanged."""
        with self._sched_lock:
            sc = self.scheduler
            if self._staged and not (sc.primed and sc.head == (epoch, 0)):
                # the window is about to reset (abandoned epoch / replay):
                # staged bytes belong to discarded batches — drop them
                with self._stage_lock:
                    self._staged.clear()
            self._dispatch(sc.start_epoch(epoch))
        yield from self.shuffler.epoch_batches(epoch)

    def _dispatch(self, plans):
        """Callers hold ``_sched_lock`` (the `_plan_done` registry is
        mutated under it; the worker pops entries under it too).

        Empty-fetch plans are queued too (in background mode): a batch
        whose records were window-deduplicated into an *earlier* plan is
        ready only once that plan executed, and FIFO order makes its own
        (no-op) completion event imply exactly that — so the demand wait
        below covers dedup'd batches across epoch boundaries as well."""
        for p in plans:
            if self.background:
                self._ensure_thread()
                self._plan_done[batch_key(p.batch)] = threading.Event()
                self._queue.put(p)
            elif p.fetch.size:
                self._execute(p)

    def _ensure_thread(self):
        """Callers hold ``_sched_lock``.  Starts the worker on first use
        and — graceful degradation — respawns it if a previous incarnation
        died on something harsher than a per-plan exception (``SystemExit``
        out of a pread worker, a crashed interpreter thread).  The queue
        and plan-completion registry survive the crash, so queued plans
        resume and no demand wait is left hanging."""
        if self._closed:
            return
        if self._thread is not None and not self._thread.is_alive():
            self._thread = None
            self.worker_restarts += 1
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._prefetch_loop,
                name="prefetch-worker",
                daemon=True,
            )
            self._thread.start()

    def _prefetch_loop(self):
        plan = _STOP
        try:
            while True:
                plan = self._queue.get()
                try:
                    if plan is _STOP:
                        return
                    try:
                        self._execute(plan)
                    except Exception as e:  # noqa: BLE001
                        # a failed prefetch must not kill training: drop
                        # whatever partial state the plan left in the tier
                        # (garbage bytes must never be served) and let the
                        # demand read of the same records raise — or
                        # succeed — in the consumer's own thread
                        self.last_error = e
                        self.plans_failed += 1
                        if plan.fetch.size:
                            self.cache.invalidate(plan.fetch)
                        with self._stage_lock:
                            self._staged.pop(batch_key(plan.batch), None)
                        self.store.stats.account_degraded(1)
                    finally:
                        with self._sched_lock:
                            ev = self._plan_done.pop(
                                batch_key(plan.batch), None
                            )
                        if ev is not None:
                            ev.set()
                finally:
                    self._queue.task_done()
        except BaseException as e:  # noqa: BLE001
            # the worker itself is dying (SystemExit etc.): drop whatever
            # the in-flight plan half-inserted, release every demand
            # waiter so nobody blocks on a dead thread, and leave a
            # restart to the next _ensure_thread call
            self.last_error = e
            try:
                if plan is not _STOP and plan.fetch.size:
                    self.cache.invalidate(plan.fetch)
            except Exception:  # noqa: BLE001 - best-effort cleanup
                pass
            with self._stage_lock:
                self._staged.clear()
            with self._sched_lock:
                pending = list(self._plan_done.values())
                self._plan_done.clear()
            for ev in pending:
                ev.set()
            raise

    def _execute(self, plan):
        with _trace.span(
            "prefetch/execute",
            "cache",
            args={"records": int(plan.fetch.size), "epoch": plan.epoch,
                  "seq": plan.seq} if _trace.enabled() else None,
        ):
            self._execute_impl(plan)

    # ------------------------------------------------- retention handoff
    def _inbox_put(
        self, ids, payload, offsets, lengths, next_use, from_peer=True
    ) -> int:
        """Bank a retention push (transport delivery target).  Returns
        the record count; admission happens at drain time."""
        entry = (
            np.asarray(ids, np.int64),
            payload,
            np.asarray(offsets, np.int64),
            np.asarray(lengths, np.int64),
            np.asarray(next_use, np.int64),
            bool(from_peer),
        )
        with self._inbox_lock:
            self._inbox.append(entry)
        return len(entry[0])

    def _drain_inbox(self):
        """Insert banked pushes into the cache.  Runs at the top of every
        serve — after the previous batch retired, so the slots its dead
        (``NEVER``-priced) residents freed are available.  Declined
        records (a within-step squeeze: a peer pushed before this host's
        own departures retired) are requeued for the next drain."""
        with self._inbox_lock:
            if not self._inbox:
                return
            entries, self._inbox = self._inbox, []
        requeue = []
        for ids, payload, offs, lens, nu, from_peer in entries:
            # free_only: a pushed record is a placement winner; an
            # admission *exchange* here would evict one winner to admit
            # another — a guaranteed storage read either way.  Decline
            # instead and retry once this host's departures free slots.
            ins, ib = self.cache.insert(
                ids, payload, offs, next_use=nu, filtered=True,
                with_bytes=True, free_only=True,
            )
            if from_peer:
                # receiver-side transfer accounting: a banked push is the
                # cross-host tier serving this record's next-epoch use
                self.store.stats.account_peer_refills(ins, ib)
                self.store.stats.account_remote_hits(ins, ib)
            if ins < len(ids):
                left = ~self.cache.resident(ids)
                if left.any():
                    requeue.append(
                        (ids[left], payload, offs[left], lens[left],
                         nu[left], from_peer)
                    )
        if requeue:
            with self._inbox_lock:
                self._inbox = requeue + self._inbox

    def _push_retained(self, idx, src, src_off, lens, spec):
        """Hand each just-consumed record to its predicted next-epoch
        holder: peers via the transport, this host via its own inbox.
        Rows are copied into a fresh arena — the serve buffer may be a
        reusable ring slot."""
        hold, pos = spec
        for g in np.unique(hold):
            if g < 0:
                continue
            rows = np.flatnonzero(hold == g)
            ids = idx[rows]
            rl = lens[rows]
            offs = np.zeros(len(rl), np.int64)
            if len(rl) > 1:
                np.cumsum(rl[:-1], out=offs[1:])
            arena = np.empty(int(rl.sum()), np.uint8)
            copy_records(src, src_off[rows], arena, offs, rl)
            try:
                if g == getattr(self.shuffler, "host_id", None):
                    self._inbox_put(
                        ids, arena, offs, rl, pos[rows], from_peer=False
                    )
                else:
                    self.remote.push(g, ids, arena, offs, rl, pos[rows])
                self.pushed_records += len(ids)
            except OSError:
                # a lost push costs the receiver one storage read next
                # epoch — degradation, never corruption
                self.push_errors += 1

    def _stage_put(self, key, ids, payload, offs):
        """File staged bytes for a batch: served by :meth:`_staged_into`
        at demand time, outside the cache tier."""
        entry = (
            np.asarray(ids, np.int64),
            payload,
            np.asarray(offs, np.int64),
        )
        with self._stage_lock:
            self._staged.setdefault(key, []).append(entry)

    def _execute_impl(self, plan):
        need = plan.fetch
        use_pos = plan.use_pos
        peer = plan.peer
        key = batch_key(plan.batch)
        # placement-routed belady tier: every plan read bypasses the
        # cache and is staged for its one window use — retention happens
        # at retirement via the push handoff, so the tier's occupancy
        # follows the placement's feasible trajectory instead of
        # absorbing the pinned window
        staging = self.scheduler._stage_floor
        stage = None
        if need.size:
            # re-check residency at execution time: the demand path may
            # have read (and inserted) these records while the plan sat
            # in the queue
            alive = ~self.cache.resident(need)
            need = need[alive]
            if use_pos is not None:
                use_pos = use_pos[alive]
            if peer is not None:
                peer = peer[alive]
        if need.size and staging:
            stage = np.ones(len(need), bool)
        if need.size and self.planner:
            # admission probe *before* the read: a record the cache would
            # decline (plan-time occupancy drifted — demand inserts landed
            # in the meantime) must not be read here, or the demand path
            # would read it a second time.  Dropping it now keeps every
            # planner-skipped record a single, expected demand miss.
            # Counted here (not in cache.planned_skips): the demand
            # path's own filtered insert will run — and count — the
            # final admission decision for these records exactly once.
            # Staged records skip the probe: they never enter the cache.
            pr = (
                np.flatnonzero(~stage)
                if stage is not None
                else np.arange(len(need), dtype=np.int64)
            )
            if len(pr):
                ok = self.cache.admit(
                    need[pr],
                    next_use=use_pos[pr] if use_pos is not None else None,
                )
                if not ok.all():
                    skipped = need[pr[~ok]]
                    self.probe_skips += len(skipped)
                    self.probe_skip_bytes += int(
                        self.cache.record_lengths[skipped].sum()
                    )
                    keep = np.ones(len(need), bool)
                    keep[pr[~ok]] = False
                    need = need[keep]
                    if use_pos is not None:
                        use_pos = use_pos[keep]
                    if peer is not None:
                        peer = peer[keep]
                    if stage is not None:
                        stage = stage[keep]
        if need.size and self.remote is not None:
            # cross-host tier: records whose predicted holder is a peer
            # are pulled host-to-host here, at plan time, so the network
            # round-trip overlaps compute exactly like the storage
            # prefetch does.  Served retention winners are inserted (the
            # consumer now caches them — the placement rule's handoff),
            # staged records go to the side buffer; both drop out of the
            # storage read below, and a peer miss stays in ``need``.
            got = np.zeros(len(need), bool)
            for sel, payload, offs, lens in self.remote.fetch_groups(
                need, plan.epoch
            ):
                sel_ids = need[sel]
                stm = stage[sel] if stage is not None else None
                if stm is not None and stm.any():
                    self._stage_put(key, sel_ids[stm], payload, offs[stm])
                cb = ~stm if stm is not None else np.ones(len(sel_ids), bool)
                if cb.any():
                    ins, ib = self.cache.insert(
                        sel_ids[cb],
                        payload,
                        offs[cb],
                        next_use=(
                            use_pos[sel][cb] if use_pos is not None else None
                        ),
                        filtered=self.planner,
                        with_bytes=True,
                    )
                    self.store.stats.account_peer_refills(ins, ib)
                self.store.stats.account_remote_hits(len(sel_ids),
                                                     int(lens.sum()))
                got[sel] = True
            nr = int(got.sum())
            if nr:
                self.prefetch_remote_records += nr
                need = need[~got]
                if use_pos is not None:
                    use_pos = use_pos[~got]
                if peer is not None:
                    peer = peer[~got]
                if stage is not None:
                    stage = stage[~got]
            if need.size and peer is not None:
                # Records with a predicted holder that could not be served
                # *yet* are deferred to the demand path, never read from
                # storage here.  A lookahead window straddling an epoch
                # boundary plans epoch-(e+1) head batches while the
                # predicted holders — a peer, or this very host — are
                # still consuming epoch e: the records aren't resident
                # anywhere *at plan time*, but lockstep consumption
                # guarantees they will be by demand time (every holder
                # finishes epoch e first).  Falling back to storage here
                # is what pushed fleet reads above the (1 − c_global)·n
                # pigeonhole floor at the epoch edges; deferred records
                # are re-asked at demand (``_remote_into`` for a peer
                # holder, a plain local gather for a self holder), and a
                # genuine miss still storage-reads exactly once.
                routed = peer >= 0
                nd = int(routed.sum())
                if nd:
                    self.peer_deferred += nd
                    need = need[~routed]
                    if use_pos is not None:
                        use_pos = use_pos[~routed]
                    if stage is not None:
                        stage = stage[~routed]
        if need.size == 0:
            return
        rb = self.store.read_batch_ragged(
            need, gap_bytes=self.gap_bytes, workers=self.workers
        )
        if stage is not None and stage.any():
            self._stage_put(key, need[stage], rb.arena, rb.offsets[stage])
            cb = ~stage
            ins, ib = self.cache.insert(
                need[cb],
                rb.arena,
                rb.offsets[cb],
                next_use=use_pos[cb] if use_pos is not None else None,
                filtered=self.planner,
                with_bytes=True,
            )
        else:
            ins, ib = self.cache.insert(
                need,
                rb.arena,
                rb.offsets,
                next_use=use_pos,
                filtered=self.planner,
                with_bytes=True,
            )
        self.store.stats.account_prefetch_fills(ins, ib)
        self.prefetch_batches += 1
        self.prefetch_records += len(need)

    # -------------------------------------------------------------- serve
    def __call__(self, indices: np.ndarray):
        with _trace.timed("prefetch/serve", "cache") as sp:
            out = self._serve(indices)
        _metrics.observe("prefetch/batch_assembly_seconds", sp.duration_s)
        return out

    def _serve(self, indices: np.ndarray):
        idx = np.asarray(indices, np.int64)
        key = batch_key(idx)
        if self._push_on and self._inbox:
            # previous batch retired at the end of the last serve — its
            # dead residents' slots are free, so banked pushes land now
            self._drain_inbox()
        with self._sched_lock:
            if self.background and self._thread is not None:
                # graceful degradation: a crashed worker is respawned here
                # (the queue and registry survive), so one dead thread
                # costs at most the plans it had in flight — the demand
                # path below re-reads those
                self._ensure_thread()
            if not self.scheduler.primed:
                self._dispatch(self.scheduler.fill())
            ev = self._plan_done.get(key)
            # post-use priorities for the admission-filtered demand
            # insert: each served record re-prices at its next-epoch use
            nu = (
                self.scheduler.next_use_after(idx, key)
                if self.planner
                else None
            )
            # the batch's epoch, for routing demand misses to their
            # predicted peer (placement tables are per-epoch coordinates)
            # and for pricing the retention push below
            epoch = (
                self.scheduler.epoch_of(key)
                if self.remote is not None
                else None
            )
            spec = (
                self.scheduler.push_spec(idx, epoch)
                if self._push_on and epoch is not None
                else None
            )
        if ev is not None:
            # this batch's prefetch is queued or running: wait for it
            # rather than issuing a duplicate storage read (timeout =
            # safety valve; the miss path below stays correct regardless)
            with _trace.span("prefetch/plan_wait", "cache"):
                if not ev.wait(timeout=self.plan_wait_s):
                    self.plan_waits_timed_out += 1
                    self.store.stats.account_degraded(1)
        out = (
            self._serve_dense(idx, nu, epoch)
            if self.mode == "dense"
            else self._serve_ragged(idx, nu, epoch)
        )
        if spec is not None:
            # consumer-side retention handoff: every just-served record
            # with a predicted next-epoch holder is pushed there now,
            # overlapped with the consumer's compute on ``out``
            if self.mode == "dense":
                rs = int(self.store.record_size)
                self._push_retained(
                    idx,
                    out.reshape(-1),
                    np.arange(len(idx), dtype=np.int64) * rs,
                    np.full(len(idx), rs, np.int64),
                    spec,
                )
            else:
                self._push_retained(
                    idx,
                    out.arena,
                    out.offsets.astype(np.int64),
                    out.lengths.astype(np.int64),
                    spec,
                )
        # serve first, then slide: the served batch's pins drop only
        # after its bytes are safely materialized.  Retirement is by
        # batch identity — multi-producer pipelines complete fetches out
        # of order, and retiring the head would unpin a different,
        # still-unserved batch
        with self._sched_lock:
            self._dispatch(self.scheduler.advance(idx))
        return out

    def _staged_into(self, idx, hit, dst, dst_off):
        """Serve this batch's staged floor records: pop the staging
        entries and copy any still-missing rows straight from the staged
        arenas into the output buffer — the cache is never touched, and
        the entry is freed here (each staged record has exactly one
        window use).  Returns the served mask over ``idx``."""
        served = np.zeros(len(idx), bool)
        with self._stage_lock:
            entries = self._staged.pop(batch_key(idx), None)
        if not entries:
            return served
        order = np.argsort(idx, kind="stable")
        sidx = idx[order]
        for ids, payload, offs in entries:
            pos = np.minimum(
                np.searchsorted(sidx, ids), max(len(sidx) - 1, 0)
            )
            rows = order[pos]
            okm = (idx[rows] == ids) & ~hit[rows] & ~served[rows]
            if not okm.any():
                continue
            rows = rows[okm]
            copy_records(
                payload,
                offs[okm],
                dst,
                dst_off[rows],
                self.cache.record_lengths[ids[okm]],
            )
            served[rows] = True
        self.staged_records += int(served.sum())
        return served

    def _remote_into(self, idx, miss, dst, dst_off, nu, epoch):
        """Demand-side cross-host serve: fetch the missed records'
        predicted peers, copy served payloads straight into the output
        buffer rows, and insert them into the local cache (the consumer
        caches what it just pulled — placement handoff).  Returns the
        served mask over ``idx``; residual misses take the storage
        path."""
        served = np.zeros(len(idx), bool)
        if self.remote is None or epoch is None:
            return served
        mi = np.flatnonzero(miss)
        if len(mi) == 0:
            return served
        for sel, payload, offs, lens in self.remote.fetch_groups(
            idx[mi], epoch
        ):
            rows = mi[sel]
            copy_records(payload, offs, dst, dst_off[rows], lens)
            self.cache.insert(
                idx[rows],
                payload,
                offs,
                next_use=nu[rows] if nu is not None else None,
                filtered=self.planner,
            )
            self.store.stats.account_remote_hits(len(rows), int(lens.sum()))
            served[rows] = True
        self.demand_remote_records += int(served.sum())
        return served

    def _serve_dense(self, indices, nu=None, epoch=None) -> np.ndarray:
        idx = np.asarray(indices, np.int64)
        b = len(idx)
        rs = int(self.store.record_size)
        out = (
            self.ring.acquire(b)
            if self.ring is not None
            else np.empty((b, rs), np.uint8)
        )
        if b == 0:
            return out
        try:
            dst_off = np.arange(b, dtype=np.int64) * rs
            hit = self.cache.gather(idx, out.reshape(-1), dst_off)
            nh = int(hit.sum())
            if self._staged and not hit.all():
                hit = hit | self._staged_into(
                    idx, hit, out.reshape(-1), dst_off
                )
            if self.remote is not None and not hit.all():
                hit = hit | self._remote_into(
                    idx, ~hit, out.reshape(-1), dst_off, nu, epoch
                )
            miss = ~hit
            if nh == 0 and not hit.any():
                # zero-copy handoff, miss side: nothing resident (cold
                # epoch / 0-budget tier) — read storage straight into the
                # destination (ring) buffer, no tmp batch + row copy
                self.store.read_batch_into(
                    idx, out=out, gap_bytes=self.gap_bytes, workers=self.workers
                )
                if not self._push_on:
                    self.cache.insert(
                        idx,
                        out.reshape(-1),
                        dst_off,
                        next_use=nu,
                        filtered=self.planner,
                    )
            elif miss.any():
                tmp = self.store.read_batch_into(
                    idx[miss], gap_bytes=self.gap_bytes, workers=self.workers
                )
                self.cache.account_scratch_copy(tmp.nbytes)
                out[miss] = tmp
                if not self._push_on:
                    # push mode populates the cache only through the
                    # retention handoff — a demand insert here would
                    # squat on a slot the placement promised to a push
                    self.cache.insert(
                        idx[miss],
                        tmp.reshape(-1),
                        np.arange(len(tmp), dtype=np.int64) * rs,
                        next_use=nu[miss] if nu is not None else None,
                        filtered=self.planner,
                    )
            # fully-resident batches take the hit side of the handoff:
            # one gather, cache arena → ring slot, zero scratch copies
            if nh:
                self.store.stats.account_cache_hits(nh, nh * rs)
            return out
        except BaseException:
            if self.ring is not None:
                self.ring.recycle(out)  # failed fetch must not drain the ring
            raise

    def _serve_ragged(self, indices, nu=None, epoch=None) -> RaggedBatch:
        idx = np.asarray(indices, np.int64)
        b = len(idx)
        lens = self.store.lengths()[idx] if b else np.empty(0, np.int64)
        arena, out_off, out_len = alloc_ragged(lens, self.ring)
        if b == 0:
            return RaggedBatch(arena, out_off, out_len)
        try:
            dst_off = out_off.astype(np.int64)
            hit = self.cache.gather(idx, arena, dst_off)
            # byte accounting wants the cache-gather hits only, so every
            # merge below is non-mutating (``hit = hit | ...``)
            dram_hit = hit
            nh = int(hit.sum())
            if self._staged and not hit.all():
                hit = hit | self._staged_into(idx, hit, arena, dst_off)
            if self.remote is not None and not hit.all():
                hit = hit | self._remote_into(
                    idx, ~hit, arena, dst_off, nu, epoch
                )
            miss = ~hit
            if nh == 0 and not hit.any():
                # zero-copy handoff (see _serve_dense): the extent gather
                # materializes directly into the ring arena
                self.store.read_batch_ragged(
                    idx,
                    gap_bytes=self.gap_bytes,
                    workers=self.workers,
                    out=(arena, out_off, out_len),
                )
                if not self._push_on:
                    self.cache.insert(
                        idx, arena, dst_off, next_use=nu, filtered=self.planner
                    )
            elif miss.any():
                rb = self.store.read_batch_ragged(
                    idx[miss], gap_bytes=self.gap_bytes, workers=self.workers
                )
                self.cache.account_scratch_copy(rb.arena.nbytes)
                copy_records(
                    rb.arena, rb.offsets, arena, dst_off[miss], rb.lengths
                )
                if not self._push_on:
                    # see _serve_dense: retention is push-only here
                    self.cache.insert(
                        idx[miss],
                        rb.arena,
                        rb.offsets,
                        next_use=nu[miss] if nu is not None else None,
                        filtered=self.planner,
                    )
            if nh:
                self.store.stats.account_cache_hits(
                    nh, int(lens[dram_hit].sum())
                )
            return RaggedBatch(arena, out_off, out_len)
        except BaseException:
            if self.ring is not None:
                self.ring.recycle(arena)
            raise

    # ----------------------------------------------------------- lifecycle
    def drain(self):
        """Block until every queued prefetch plan has executed (tests and
        benchmarks; the training path never needs it)."""
        if self._thread is not None:
            self._queue.join()

    def close(self):
        """Stop the background worker (cache contents stay valid)."""
        self._closed = True
        if self._thread is not None:
            self._queue.put(_STOP)
            self._thread.join()
            self._thread = None
        with self._stage_lock:
            self._staged.clear()
        with self._inbox_lock:
            self._inbox.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
