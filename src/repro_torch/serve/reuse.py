"""Estimated-reuse admission for the request-stream feature cache.

Training's tier is clairvoyant: LIRS fixes the permutation, so every
record's next use is *known* and Belady eviction/admission are exact.
A serving request stream has no such oracle — but the admission
machinery (:meth:`TieredCache.admit` / ``insert(next_use=, filtered=True)``)
only needs *priorities*, not truth.  :class:`EstimatedReusePolicy`
supplies them: an EWMA over each id's interarrival gap turns frequency
and recency into an estimated next-use stream position (hot ids → soon,
cold/unseen ids → far), and the exact same exchange, eviction, and
accounting code that serves training serves the request stream.

This is the NoPFS admission exchange with estimated reuse replacing
exact next-use (cf. "Clairvoyant Prefetching for Distributed ML I/O").
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.prefetch.cache import TieredCache


class EstimatedReusePolicy:
    """Per-id EWMA interarrival estimator → estimated next-use positions.

    ``observe(ids, now)`` folds the gap since each id's previous sighting
    into its EWMA; ``estimate_next_use(ids, now)`` answers ``now +
    estimated_gap`` for seen ids and ``now + cold_gap`` for first-timers,
    so unseen ids look like far-future uses and lose the admission
    exchange against established hot ids.
    """

    def __init__(self, num_items: int, *, ewma: float = 0.3,
                 cold_gap: Optional[float] = None):
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        self.ewma = float(ewma)
        # a cold id's assumed gap: large enough to lose exchanges against
        # any observed-hot id, small enough to stay well under NEVER
        self.cold_gap = float(cold_gap if cold_gap is not None else 4 * num_items)
        self._last_seen = np.full(num_items, -1.0)
        self._gap = np.full(num_items, self.cold_gap)
        self._seen = np.zeros(num_items, bool)

    def observe(self, ids: np.ndarray, now: float) -> None:
        ids = np.unique(np.asarray(ids, np.int64))
        seen = self._seen[ids]
        old = ids[seen]
        if len(old):
            gaps = now - self._last_seen[old]
            self._gap[old] += self.ewma * (gaps - self._gap[old])
        self._last_seen[ids] = now
        self._seen[ids] = True

    def estimate_next_use(self, ids: np.ndarray, now: float) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        return np.rint(now + self._gap[ids]).astype(np.int64)


class RequestStreamCache:
    """:class:`TieredCache` repurposed as a served feature/record cache.

    ``fetch(ids, now)`` is the whole read path for one request's feature
    set: gather hits from the DRAM arena, read misses from the store's
    coalesced batch engine, and offer the misses back through the
    admission-filtered insert with :class:`EstimatedReusePolicy`
    priorities.  Hits are accounted on the store's
    :class:`~repro_torch.storage.record_store.IOStats` via
    ``account_cache_hits`` — the same counters the training tier feeds —
    so ``store.stats.cache_hits == cache.hits`` reconciles by
    construction.
    """

    def __init__(
        self,
        store,
        budget_bytes: int,
        *,
        policy: str = "belady",
        ewma: float = 0.3,
        cold_gap: Optional[float] = None,
    ):
        if store.variable:
            raise ValueError(
                "RequestStreamCache serves fixed-size feature records"
            )
        self.store = store
        lengths = store.lengths()
        self.record_size = int(store.record_size)
        self.cache = TieredCache(lengths, budget_bytes, policy=policy)
        self.policy = EstimatedReusePolicy(
            store.num_records, ewma=ewma, cold_gap=cold_gap
        )
        self.fetched = 0

    @property
    def hit_rate(self) -> float:
        total = self.cache.hits + self.cache.misses
        return self.cache.hits / total if total else 0.0

    def fetch(self, ids: np.ndarray, now: float) -> Tuple[np.ndarray, np.ndarray]:
        """Serve ``ids`` (one request's features): returns
        ``(records, hit_mask)`` with ``records`` a ``(B, record_size)``
        uint8 batch, hits from DRAM and misses from storage."""
        ids = np.asarray(ids, np.int64)
        rsize = self.record_size
        self.policy.observe(ids, now)
        out = np.empty((len(ids), rsize), np.uint8)
        flat = out.reshape(-1)
        offs = np.arange(len(ids), dtype=np.int64) * rsize
        hit = self.cache.gather(ids, flat, offs)
        nh = int(hit.sum())
        if nh:
            self.store.stats.account_cache_hits(nh, nh * rsize)
        miss_ids = ids[~hit]
        if len(miss_ids):
            batch = self.store.read_batch_into(miss_ids)
            out[~hit] = batch
            nu = self.policy.estimate_next_use(miss_ids, now)
            self.cache.insert(
                miss_ids,
                batch.reshape(-1),
                np.arange(len(miss_ids), dtype=np.int64) * rsize,
                next_use=nu,
                filtered=True,
            )
        # freshen resident hit priorities with the post-observation
        # estimates — recency keeps hot residents winning future exchanges
        hit_ids = ids[hit]
        if len(hit_ids):
            self.cache.note_next_use(
                hit_ids, self.policy.estimate_next_use(hit_ids, now)
            )
        self.fetched += len(ids)
        return out, hit
