"""LRU and Belady (clairvoyant) cache simulators.

``LRUPageCache`` models the host main-memory page cache the paper reasons
about in §4.1 (page-aware shuffling): when instance_size < page size and
instances are fetched in random order, most of each loaded page is evicted
unused and later re-fetched — redundant page transfers.  The simulator
counts those transfers so Fig 11 reproduces without real block devices.

``BeladyPageCache`` is its clairvoyant sibling: same demand-fill cache,
but eviction takes the resident with the *farthest next use* — computable
offline because the whole access stream is known, which is exactly the
situation LIRS puts the DRAM tier in (the epoch order is a known
permutation).  Both run at any granularity; the prefetch subsystem's
closed forms (``repro_torch.storage.devices.cache_hit_model``) are
validated against them at *record* granularity over real shuffler index
streams.

The port's copy of the JAX package's numpy-only module.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np

_NEVER = np.iinfo(np.int64).max


class LRUPageCache:
    def __init__(self, capacity_pages: int):
        assert capacity_pages > 0
        self.capacity = capacity_pages
        self._lru: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def access(self, page: int) -> bool:
        """Returns True on hit."""
        if page in self._lru:
            self._lru.move_to_end(page)
            self.hits += 1
            return True
        self.misses += 1
        self._lru[page] = None
        if len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
        return False

    def access_many(self, pages: Iterable[int]) -> int:
        m0 = self.misses
        for p in pages:
            self.access(p)
        return self.misses - m0

    def simulate(self, stream: Sequence[int], warmup: int = 0) -> float:
        """Run the whole ``stream``; count hits/misses only for accesses
        at position ≥ ``warmup`` (steady-state measurement).  Returns the
        measured hit rate over the counted tail."""
        for t, p in enumerate(stream):
            hit = self.access(int(p))
            if t < warmup:  # warm-up accesses populate but don't count
                self.hits -= int(hit)
                self.misses -= int(not hit)
        tail = self.hits + self.misses
        return self.hits / tail if tail else 0.0

    @property
    def transfers(self) -> int:
        """Pages moved storage -> memory (i.e. misses)."""
        return self.misses

    def reset(self):
        self._lru.clear()
        self.hits = self.misses = 0


class BeladyPageCache:
    """Demand-fill cache with Belady's MIN eviction (farthest next use).

    Clairvoyance means eviction needs the *future* of the stream, so the
    API is offline: :meth:`simulate` takes the whole access sequence,
    derives each access's next-occurrence time with one backward pass,
    and replays it — on a miss the resident whose next use is farthest
    (``_NEVER`` for never-again) is evicted, via a vectorized argmax over
    a dense per-id next-use array (no heap).  Counters mirror
    :class:`LRUPageCache` so the two simulators are drop-in comparable
    on the same stream.
    """

    def __init__(self, capacity_pages: int):
        assert capacity_pages > 0
        self.capacity = capacity_pages
        self.hits = 0
        self.misses = 0

    @staticmethod
    def next_use_times(stream: np.ndarray) -> np.ndarray:
        """``out[t]`` = position of the next occurrence of ``stream[t]``
        after ``t`` (``_NEVER`` when there is none).  One vectorized
        backward scan per distinct id, O(T) total."""
        stream = np.asarray(stream, np.int64)
        t_len = len(stream)
        out = np.full(t_len, _NEVER, np.int64)
        if t_len == 0:
            return out
        # group positions by id: for each id's sorted positions p0<p1<…,
        # out[p_i] = p_{i+1}
        order = np.argsort(stream, kind="stable")
        sid = stream[order]
        same_next = sid[:-1] == sid[1:]
        out[order[:-1][same_next]] = order[1:][same_next]
        return out

    def simulate(self, stream: Sequence[int], warmup: int = 0) -> float:
        """Replay ``stream`` under MIN; count only accesses at position
        ≥ ``warmup``.  Returns the measured hit rate over the tail.
        Residency carries over between calls is NOT supported — each call
        is a fresh offline run (clairvoyance is per-stream)."""
        stream = np.asarray(stream, np.int64)
        nxt = self.next_use_times(stream)
        n_ids = int(stream.max()) + 1 if len(stream) else 0
        resident_next = np.full(n_ids, -1, np.int64)  # -1 = absent
        count = 0
        for t in range(len(stream)):
            x = stream[t]
            hit = resident_next[x] >= 0
            if t >= warmup:
                self.hits += int(hit)
                self.misses += int(not hit)
            resident_next[x] = nxt[t]
            if not hit:
                count += 1
                if count > self.capacity:
                    cand = np.flatnonzero(resident_next >= 0)
                    victim = cand[np.argmax(resident_next[cand])]
                    resident_next[victim] = -1
                    count -= 1
        tail = self.hits + self.misses
        return self.hits / tail if tail else 0.0

    @property
    def transfers(self) -> int:
        return self.misses

    def reset(self):
        self.hits = self.misses = 0


class DistributedCacheSim:
    """Record-level simulator of the multi-host clairvoyant tier.

    ``H`` hosts each own a demand-fill cache over the records they
    consume (host = slot range of each global batch, the
    :func:`repro_torch.sharding.placement.host_slice_bounds` rule).  An access
    resolves through the tier order the live system uses:

    1. consumer's own cache → **local** hit;
    2. any peer's cache → **remote** hit, and the record *moves*
       (release-on-serve: the peer frees its slot, the consumer now
       caches it — consumer-caches placement, no double counting);
    3. otherwise → **storage** read by the consumer.

    Retention is per-host: ``belady`` inserts then evicts the resident
    with the farthest *global* next use (the admission-exchange
    semantics of :class:`repro_torch.prefetch.cache.TieredCache` — the new
    record itself loses when it is the farthest), ``lru`` evicts least
    recently used.  Next-use times are global positions over the whole
    multi-epoch stream, so cross-host reuse prices correctly.

    This is the ground truth the closed forms are validated against:
    :func:`repro_torch.storage.devices.distributed_hit_model` for the
    local/remote/storage split, and
    :meth:`repro_torch.sharding.placement.ClairvoyantPlacement.expected_storage_reads`
    for the aggregate pigeonhole floor ``n − sum(capacity_h)`` per
    steady-state epoch.
    """

    def __init__(self, num_hosts: int, capacities: Sequence[int], policy: str = "belady"):
        if len(capacities) != num_hosts:
            raise ValueError("need one capacity per host")
        if policy not in ("lru", "belady"):
            raise ValueError(f"unknown policy {policy!r}")
        self.num_hosts = int(num_hosts)
        self.capacities = [int(c) for c in capacities]
        self.policy = policy

    def _consumers(self, shuffler, epoch: int) -> np.ndarray:
        from repro_torch.sharding.placement import host_slice_bounds

        parts = []
        for batch in shuffler.epoch_batches(epoch):
            b = host_slice_bounds(len(batch), self.num_hosts)
            parts.append(np.repeat(np.arange(self.num_hosts), np.diff(b)))
        return np.concatenate(parts) if parts else np.empty(0, np.int64)

    def simulate(self, shuffler, epochs: int):
        """Replay ``epochs`` epochs of ``shuffler``'s global stream.
        Returns one dict per epoch:
        ``{"local", "remote", "storage", "accesses"}`` (record counts)."""
        n = shuffler.num_items
        streams = [np.asarray(shuffler.epoch_index_stream(e), np.int64) for e in range(epochs)]
        consumers = [self._consumers(shuffler, e) for e in range(epochs)]
        flat = np.concatenate(streams) if streams else np.empty(0, np.int64)
        nxt = BeladyPageCache.next_use_times(flat)
        resident_host = np.full(n, -1, np.int64)
        resident_next = np.full(n, _NEVER, np.int64)
        counts = [0] * self.num_hosts
        lru: list[OrderedDict[int, None]] = [OrderedDict() for _ in range(self.num_hosts)]
        out = []
        t = 0
        for e in range(epochs):
            stats = {"local": 0, "remote": 0, "storage": 0, "accesses": len(streams[e])}
            for pos in range(len(streams[e])):
                r = int(streams[e][pos])
                h = int(consumers[e][pos])
                g = int(resident_host[r])
                if g == h:
                    stats["local"] += 1
                elif g >= 0:
                    stats["remote"] += 1
                    counts[g] -= 1  # release-on-serve
                    if self.policy == "lru":
                        del lru[g][r]
                    resident_host[r] = -1
                else:
                    stats["storage"] += 1
                # consumer-caches retention at h
                if self.capacities[h] > 0:
                    if g != h:
                        resident_host[r] = h
                        counts[h] += 1
                    resident_next[r] = nxt[t]
                    if self.policy == "lru":
                        lru[h][r] = None
                        lru[h].move_to_end(r)
                        if counts[h] > self.capacities[h]:
                            victim, _ = lru[h].popitem(last=False)
                            resident_host[victim] = -1
                            counts[h] -= 1
                    elif counts[h] > self.capacities[h]:
                        cand = np.flatnonzero(resident_host == h)
                        victim = int(cand[np.argmax(resident_next[cand])])
                        resident_host[victim] = -1
                        resident_next[victim] = _NEVER
                        counts[h] -= 1
                elif g == h:  # pragma: no cover - capacity 0 can't hold
                    resident_host[r] = -1
                    counts[h] -= 1
                t += 1
            out.append(stats)
        return out
