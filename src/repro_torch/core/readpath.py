"""The unified read-path API: one config object, one entry point.

The read path accreted knobs one at a time — dense/ragged modes,
buffer rings, coalescing gaps, reader pools, the tiered DRAM
cache with lookahead prefetch, eviction policies, the
admission planner, and the cross-host tier — until
``store_fetch_fn`` took fifteen keyword arguments and every launcher
mirrored them as flags.  :class:`ReadPathConfig` freezes that knob set
into a single value object and :func:`build_data_plane` is the one
constructor every consumer (training launcher, serving launcher,
benchmarks, tests) calls; ``store_fetch_fn(**kwargs)`` survives as a
deprecated shim that builds the equivalent config.

The returned *data plane* is a plain ``fetch_fn(indices) -> batch``
closure for the direct paths, or a
:class:`~repro_torch.prefetch.fetcher.PrefetchingFetcher` (itself
callable) for the tiered path, with ``plane.batch_iter``, ``plane.cache``
and ``plane.close()``.  :func:`batch_iter_fn_of` and
:func:`close_data_plane` paper over the difference for generic callers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.storage.record_store import (
    PAGE,
    BatchBufferRing,
    RaggedBufferRing,
    RecordStore,
)

READ_PATH_MODES = ("auto", "dense", "ragged")


@dataclasses.dataclass(frozen=True)
class ReadPathConfig:
    """Every read-path decision in one frozen value.

    Field semantics are unchanged from the historical ``store_fetch_fn``
    keywords (see :func:`build_data_plane` for the full story):

    * ``mode`` — ``auto`` | ``dense`` | ``ragged`` batch materialization.
    * ``ring`` — optional :class:`BatchBufferRing` /
      :class:`RaggedBufferRing` destination recycling.
    * ``gap_bytes`` / ``workers`` — coalescing gap and reader-pool width
      (host-side NVM queue depth) for the storage pread path.
    * ``shuffler`` + ``cache_budget_bytes`` > 0 — select the tiered DRAM
      read path along the shuffler's known index stream.
    * ``lookahead`` / ``prefetch_background`` / ``max_epochs`` — the
      clairvoyant window: how many batches ahead plans are staged,
      whether a background worker executes them, and where the stream
      ends.
    * ``eviction_policy`` (``lru`` | ``belady``) and
      ``prefetch_planner`` (None = auto: on for belady) — retention and
      admission of the tier.
    * ``remote`` / ``placement`` — the cross-host tier
      (:mod:`repro_torch.prefetch.distributed`).
    """

    mode: str = "auto"
    ring: Optional[Any] = None
    gap_bytes: int = PAGE
    workers: int = 1
    shuffler: Optional[Any] = None
    cache_budget_bytes: int = 0
    lookahead: int = 8
    prefetch_background: bool = True
    max_epochs: Optional[int] = None
    eviction_policy: str = "lru"
    prefetch_planner: Optional[bool] = None
    remote: Optional[Any] = None
    placement: Optional[Any] = None

    @property
    def tiered(self) -> bool:
        """Whether this config selects the DRAM-tier read path."""
        return self.cache_budget_bytes > 0

    def validate(self) -> "ReadPathConfig":
        from repro_torch.storage.devices import EVICTION_POLICIES

        if self.mode not in READ_PATH_MODES:
            raise ValueError(
                f"mode must be one of {READ_PATH_MODES}, got {self.mode!r}"
            )
        if self.eviction_policy not in EVICTION_POLICIES:
            raise ValueError(
                f"eviction policy must be one of {EVICTION_POLICIES}, "
                f"got {self.eviction_policy!r}"
            )
        if self.tiered and self.shuffler is None:
            raise ValueError("the tiered read path needs shuffler=")
        return self

    def replace(self, **kw) -> "ReadPathConfig":
        return dataclasses.replace(self, **kw)


def build_data_plane(
    store: RecordStore, config: Optional[ReadPathConfig] = None
) -> Callable[[np.ndarray], Any]:
    """Build the read path described by ``config`` over ``store``.

    Returns the *data plane*: a ``fetch_fn`` suitable for
    :class:`~repro_torch.core.pipeline.InputPipeline`.

    With ``config.cache_budget_bytes == 0`` this is a plain closure over
    the coalesced batch engines — ``mode='dense'`` materializes
    fixed-size batches with ``read_batch_into`` (into ``ring`` buffers
    when given a :class:`BatchBufferRing`), ``mode='ragged'``
    variable-length batches with ``read_batch_ragged`` (arena triples,
    optionally from a :class:`RaggedBufferRing`), and ``'auto'`` picks
    ragged for variable-length stores and dense otherwise.

    With a budget (and a ``shuffler``) it is the tiered read path: a
    :class:`~repro_torch.prefetch.fetcher.PrefetchingFetcher` serving
    resident records from a byte-budgeted DRAM cache, prefetching future
    batches along the shuffler's known index stream, evicting by
    ``eviction_policy`` and admission-filtering by ``prefetch_planner``
    (None = auto: on for a Belady tier).  Batch bytes are identical with
    the tier on or off, for every policy and planner setting; pass the
    returned fetcher's ``batch_iter`` as the pipeline's
    ``batch_iter_fn`` so the lookahead window re-syncs at epoch
    boundaries.  ``remote`` / ``placement`` extend the tier across hosts
    — most multi-host callers should use
    :func:`repro_torch.prefetch.distributed.make_cluster` instead, which
    builds one plane per host from a shared placement.

    Pair with ``InputPipeline(recycle_fn=ring.recycle)`` for the
    allocation-free steady state; both ring classes ignore foreign
    arrays, so the blanket recycle is safe even for miss-allocated
    batches.
    """
    cfg = (config or ReadPathConfig()).validate()
    if cfg.tiered:
        from repro_torch.prefetch.fetcher import PrefetchingFetcher

        return PrefetchingFetcher(
            store,
            cfg.shuffler,
            budget_bytes=cfg.cache_budget_bytes,
            lookahead=cfg.lookahead,
            mode=cfg.mode,
            ring=cfg.ring,
            gap_bytes=cfg.gap_bytes,
            workers=cfg.workers,
            background=cfg.prefetch_background,
            max_epochs=cfg.max_epochs,
            policy=cfg.eviction_policy,
            planner=cfg.prefetch_planner,
            remote=cfg.remote,
            placement=cfg.placement,
        )
    mode = cfg.mode
    if mode == "auto":
        mode = "ragged" if store.variable else "dense"
    if mode == "dense":
        if store.variable:
            raise ValueError("dense mode needs a fixed-size store")
        ring = cfg.ring
        if ring is not None and not isinstance(ring, BatchBufferRing):
            raise TypeError("dense mode takes a BatchBufferRing")
        gap_bytes, workers = cfg.gap_bytes, cfg.workers

        def fetch_dense(idx: np.ndarray):
            out = ring.acquire(len(idx)) if ring is not None else None
            try:
                return store.read_batch_into(
                    idx, out=out, gap_bytes=gap_bytes, workers=workers
                )
            except BaseException:
                if out is not None:
                    ring.recycle(out)  # failed fetch must not drain the ring
                raise

        return fetch_dense
    ring = cfg.ring
    if ring is not None and not isinstance(ring, RaggedBufferRing):
        raise TypeError("ragged mode takes a RaggedBufferRing")
    gap_bytes, workers = cfg.gap_bytes, cfg.workers

    def fetch_ragged(idx: np.ndarray):
        return store.read_batch_ragged(
            idx, gap_bytes=gap_bytes, workers=workers, ring=ring
        )

    return fetch_ragged


def batch_iter_fn_of(plane) -> Optional[Callable]:
    """The pipeline ``batch_iter_fn`` a data plane wants, if any (the
    tiered fetcher's window re-sync); None for the direct paths."""
    return getattr(plane, "batch_iter", None)


def close_data_plane(plane) -> None:
    """Release a data plane's background resources (no-op for the
    closure paths, ``close()`` for the tiered fetcher)."""
    close = getattr(plane, "close", None)
    if close is not None:
        close()
