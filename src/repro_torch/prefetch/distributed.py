"""The cross-host record tier: distributed clairvoyant I/O (the port's
copy of ``repro.prefetch.distributed``; host code, nothing on the card).

One host's tier order becomes DRAM → **peers** → NVM.  Each host runs the
ordinary :class:`~repro_torch.prefetch.fetcher.PrefetchingFetcher` over *its*
shard of every global batch (a :class:`~repro_torch.sharding.placement.HostShardView`),
and a :class:`RemoteTier` slots between the local cache gather and the
storage read: misses whose predicted holder is a peer are fetched
host-to-host, and only the remainder touches storage.  Routing is the
closed-form :class:`~repro_torch.sharding.placement.ClairvoyantPlacement`
lookup — no directory, no gossip; the permutation *is* the metadata.

:class:`RemoteFetcher` wraps a transport with the
:class:`~repro_torch.storage.faults.RetryPolicy` per peer call: bounded
retries with exponential backoff under a deadline, and a dead peer
degrades to an all-miss answer — the caller falls back to storage, so
peer failure costs bandwidth, never correctness (the same contract the
fault-tolerant NVM read path gives for device errors).

:func:`make_cluster` assembles the whole thing in one process — ``H``
stores (separate fds and counters over the same dataset), ``H`` caches,
one shared placement, a :class:`~repro_torch.prefetch.transport.LocalTransport`
— which is both the test/benchmark harness and the reference wiring a
real multi-node launch replicates over
:class:`~repro_torch.prefetch.transport.TCPTransport` (see
``launch/mesh.py``'s CPU process mesh).

Invariant (validated in ``tests/test_torch_multihost.py`` against the
JAX package's cluster): batches are **byte-identical** to the
single-host pipeline for any host count, and under Belady the fleet's
aggregate storage reads settle at ``(1 − c_global) · n`` records/epoch —
the distributed pigeonhole floor — with remote traffic replacing the
reads a single host would have served from its (bigger) local cache.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.prefetch.cache import TieredCache, copy_records
from repro_torch.prefetch.fetcher import PrefetchingFetcher
from repro_torch.prefetch.transport import LocalTransport
from repro_torch.sharding.placement import (
    NO_HOST,
    ClairvoyantPlacement,
    HostShardView,
)
from repro_torch.storage.faults import DEFAULT_RETRY, RetryPolicy
from repro_torch.storage.record_store import PAGE


class RemoteFetcher:
    """Per-peer reads with retry/deadline semantics.

    ``fetch_from(peer, ids)`` returns the transport's
    ``(found, payload, offsets, lengths)``; transport ``OSError``s are
    retried up to ``retry.max_retries`` times with exponential backoff
    (``backoff_s · 2^k`` capped at ``backoff_cap_s``), all under
    ``retry.deadline_s``.  Exhaustion returns an all-miss mask — the
    storage fallback path — and counts a ``peer_failure``.
    """

    def __init__(
        self,
        transport,
        host_id: int,
        retry: RetryPolicy = DEFAULT_RETRY,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.transport = transport
        self.host_id = int(host_id)
        self.retry = retry
        self._clock = clock
        self._sleep = sleep
        self.remote_hits = 0       # records a peer actually served
        self.remote_hit_bytes = 0
        self.remote_misses = 0     # asked, peer answered "not resident"
        self.peer_errors = 0       # transport attempts that raised
        self.peer_failures = 0     # fetches abandoned after retries/deadline
        self.pushed = 0            # records handed to a peer's inbox

    def fetch_from(self, peer: int, ids: np.ndarray):
        with _trace.timed(
            "remote/fetch",
            "remote",
            args={"peer": int(peer), "records": len(ids)}
            if _trace.enabled()
            else None,
        ) as sp:
            out = self._fetch_from(peer, ids)
        _metrics.observe("remote/peer_rtt_seconds", sp.duration_s)
        return out

    def _fetch_from(self, peer: int, ids: np.ndarray):
        ids = np.asarray(ids, np.int64)
        deadline = (
            self._clock() + self.retry.deadline_s
            if self.retry.deadline_s is not None
            else None
        )
        for attempt in range(self.retry.max_retries + 1):
            try:
                found, payload, offsets, lens = self.transport.fetch(peer, ids)
            except OSError:
                self.peer_errors += 1
                if attempt >= self.retry.max_retries:
                    break
                pause = min(
                    self.retry.backoff_cap_s,
                    self.retry.backoff_s * (2.0**attempt),
                )
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        break
                    pause = min(pause, remaining)
                self._sleep(pause)
                continue
            nh = int(found.sum())
            self.remote_hits += nh
            self.remote_hit_bytes += int(lens.sum())
            self.remote_misses += len(ids) - nh
            return found, payload, offsets, lens
        self.peer_failures += 1
        return (
            np.zeros(len(ids), bool),
            np.empty(0, np.uint8),
            np.empty(0, np.int64),
            np.empty(0, np.int64),
        )

    def push_to(
        self, peer: int, ids, payload, offsets, lengths, next_use
    ) -> int:
        """Retention handoff to ``peer``'s inbox (consumer-side
        placement).  One attempt, no retry: a lost push degrades to one
        storage read on the receiver next epoch, which is cheaper than
        stalling the serve path here.  ``OSError`` propagates (counted)
        so the caller can tally the loss."""
        with _trace.timed(
            "remote/push_send",
            "remote",
            args={"peer": int(peer), "records": len(ids)}
            if _trace.enabled()
            else None,
        ):
            try:
                n = self.transport.push(
                    peer, ids, payload, offsets, lengths, next_use
                )
            except OSError:
                self.peer_errors += 1
                raise
        self.pushed += int(n)
        return int(n)


class RemoteTier:
    """Consumer-side routing for the cross-host tier.

    ``route`` maps record ids to predicted holders (own id → ``NO_HOST``:
    a locally-retained record is the DRAM gather's business, not a peer
    fetch).  ``fetch_groups`` groups a miss set by peer, fetches each
    group once, and yields the served slices — the shape both the
    prefetch executor (insert into cache) and the demand serve path
    (copy into the output buffer) consume."""

    def __init__(
        self,
        host_id: int,
        placement: ClairvoyantPlacement,
        fetcher: RemoteFetcher,
    ):
        self.host_id = int(host_id)
        self.placement = placement
        self.fetcher = fetcher

    def route(self, ids: np.ndarray, epoch: int) -> np.ndarray:
        peers = self.placement.peer_for(ids, epoch).copy()
        peers[peers == self.host_id] = NO_HOST
        return peers

    def fetch_groups(
        self, ids: np.ndarray, epoch: int
    ) -> Iterator[tuple]:
        """Yields ``(sel, payload, offsets, lengths)`` per serving peer,
        where ``sel`` indexes into ``ids`` (the records that peer
        actually had) and ``payload[offsets[i]:offsets[i]+lengths[i]]``
        is record ``ids[sel[i]]``."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return
        peers = self.route(ids, epoch)
        for peer in np.unique(peers):
            if peer == NO_HOST:
                continue
            sel = np.flatnonzero(peers == peer)
            found, payload, offsets, lens = self.fetcher.fetch_from(
                int(peer), ids[sel]
            )
            if found.any():
                yield sel[found], payload, offsets, lens

    def push(self, peer: int, ids, payload, offsets, lengths, next_use) -> int:
        """Retention handoff: deliver records to ``peer``'s inbox."""
        return self.fetcher.push_to(
            int(peer), ids, payload, offsets, lengths, next_use
        )


@dataclass
class HostNode:
    """One host of the in-process cluster: its own store handle (separate
    fds and ``IOStats``), shard view, cache, and tiered fetcher."""

    host_id: int
    store: object
    view: HostShardView
    cache: TieredCache
    remote: RemoteTier
    fetcher: PrefetchingFetcher

    def close(self):
        self.fetcher.close()
        self.store.close()


@dataclass
class Cluster:
    """An ``H``-host clairvoyant data plane over one dataset."""

    nodes: List[HostNode]
    placement: ClairvoyantPlacement
    transport: LocalTransport
    _closed: bool = field(default=False, repr=False)

    @property
    def num_hosts(self) -> int:
        return len(self.nodes)

    def epoch_batches(self, epoch: int) -> Iterator[List[np.ndarray]]:
        """Round-robin lockstep: yields, per global step, the list of
        every host's served shard (concatenation = the global batch,
        byte-identical to a single-host serve of the same indices).
        Stepping all hosts per global step — rather than one host per
        epoch — keeps each host at most a lookahead window ahead of its
        peers, so consumer-caches handoff finds the holder already
        populated except at epoch edges (where the storage fallback
        covers the race)."""
        iters = [
            (node.fetcher.batch_iter(epoch), node.fetcher) for node in self.nodes
        ]
        while True:
            shards = []
            for it, fetch in iters:
                part = next(it, None)
                if part is None:
                    return
                shards.append(fetch(part))
            yield shards

    def run_epoch(self, epoch: int) -> int:
        """Serve the whole epoch, discarding batch payloads; returns the
        number of global steps (benchmark/warm-up helper)."""
        steps = 0
        for _ in self.epoch_batches(epoch):
            steps += 1
        return steps

    def drain(self):
        for node in self.nodes:
            node.fetcher.drain()

    def aggregate_io(self) -> Dict[str, int]:
        """Fleet-wide counter sums — the quantities the invariant and the
        models are checked against.

        ``local_hits`` is the *cross-epoch* local tier: demand-time DRAM
        gathers minus the same-window prefetch fills that produced them
        (``peer_refills`` + ``prefetch_fills``, counted at the insert
        source).  A peer-served record is inserted into the consumer's
        cache and then gathered from it, so raw ``cache_hits`` counts the
        remote tier a second time; the source counters make the
        local/remote/storage split match ``distributed_hit_model``
        directly instead of deriving local as ``total − remote −
        storage``."""
        out = {
            "storage_records": 0,
            "storage_bytes": 0,
            "storage_ios": 0,
            "local_hits": 0,
            "local_hit_bytes": 0,
            "demand_gathers": 0,
            "peer_refills": 0,
            "prefetch_fills": 0,
            "remote_hits": 0,
            "remote_hit_bytes": 0,
            "remote_served": 0,
            "remote_served_bytes": 0,
            "peer_pushes": 0,
            "push_errors": 0,
            "staged_records": 0,
            "peer_errors": 0,
            "peer_failures": 0,
            "retries": 0,
            "degraded_batches": 0,
        }
        for node in self.nodes:
            s = node.store.stats
            out["storage_records"] += s.batch_records
            out["storage_bytes"] += s.bytes_read
            out["storage_ios"] += s.batch_ios
            out["local_hits"] += s.cache_hits - s.peer_refills - s.prefetch_fills
            out["local_hit_bytes"] += (
                s.cache_hit_bytes - s.peer_refill_bytes - s.prefetch_fill_bytes
            )
            out["demand_gathers"] += s.cache_hits
            out["peer_refills"] += s.peer_refills
            out["prefetch_fills"] += s.prefetch_fills
            out["remote_hits"] += s.remote_hits
            out["remote_hit_bytes"] += s.remote_hit_bytes
            out["remote_served"] += node.cache.remote_served
            out["remote_served_bytes"] += node.cache.remote_served_bytes
            out["peer_pushes"] += node.fetcher.pushed_records
            out["push_errors"] += node.fetcher.push_errors
            out["staged_records"] += node.fetcher.staged_records
            out["peer_errors"] += node.remote.fetcher.peer_errors
            out["peer_failures"] += node.remote.fetcher.peer_failures
            out["retries"] += s.retries
            out["degraded_batches"] += s.degraded_batches
        return out

    def reset_io(self):
        for node in self.nodes:
            node.store.stats.reset()

    def close(self):
        if self._closed:
            return
        self._closed = True
        for node in self.nodes:
            node.close()
        self.transport.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ClusterFetcher:
    """Serve **global** batches through a cluster: slice each batch by
    the host bounds, fan out to every host's tiered fetcher, reassemble.

    Drop-in for the single-host ``PrefetchingFetcher`` in a launcher
    that consumes global batches on one device (``launch/train.py
    --hosts N``): ``batch_iter(epoch)`` re-syncs every host's lookahead
    window and yields the global batches; ``__call__`` returns a dense
    ``(B, record_size)`` buffer or a reassembled
    :class:`~repro_torch.storage.record_store.RaggedBatch` — byte-identical to
    one host serving the whole batch, because each host serves exactly
    the rows of its slice."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def batch_iter(self, epoch: int) -> Iterator[np.ndarray]:
        its = [n.fetcher.batch_iter(epoch) for n in self.cluster.nodes]
        while True:
            shards = [next(it, None) for it in its]
            if any(s is None for s in shards):
                return
            yield np.concatenate(shards)

    def __call__(self, indices: np.ndarray):
        from repro_torch.sharding.placement import host_slice_bounds
        from repro_torch.storage.record_store import RaggedBatch

        idx = np.asarray(indices, np.int64)
        b = host_slice_bounds(len(idx), self.cluster.num_hosts)
        parts = [
            node.fetcher(idx[b[h] : b[h + 1]])
            for h, node in enumerate(self.cluster.nodes)
        ]
        if all(isinstance(p, np.ndarray) for p in parts):
            return np.concatenate(parts, axis=0)
        arena = np.concatenate([p.arena for p in parts])
        base = np.cumsum([0] + [p.arena.size for p in parts[:-1]])
        offsets = np.concatenate(
            [p.offsets + np.int32(o) for p, o in zip(parts, base)]
        )
        lengths = np.concatenate([p.lengths for p in parts])
        return RaggedBatch(arena, offsets, lengths)

    def drain(self):
        self.cluster.drain()

    def close(self):
        self.cluster.close()


def make_cluster(
    open_store: Callable[[], object],
    shuffler,
    num_hosts: int,
    *,
    budget_bytes: int,
    lookahead: int = 8,
    mode: str = "auto",
    gap_bytes: int = PAGE,
    workers: int = 1,
    background: bool = False,
    start_epoch: int = 0,
    max_epochs: Optional[int] = None,
    policy: str = "belady",
    planner: Optional[bool] = None,
    retry: RetryPolicy = DEFAULT_RETRY,
) -> Cluster:
    """Build an in-process ``num_hosts``-host cluster over one dataset.

    ``open_store`` returns a fresh ``RecordStore`` per call (each host
    gets its own fds, thread pool, and ``IOStats``).  ``budget_bytes``
    is the **fleet** budget, split evenly — ``c_global`` is what the
    models take, ``capacity_h = c_global·n/H`` is what each host
    enforces.  ``background=False`` (default) executes prefetch plans
    inline, which makes lockstep epoch replays deterministic — the
    byte-identity tests' mode; benchmarks flip it on.
    """
    if num_hosts < 1:
        raise ValueError("num_hosts must be >= 1")
    transport = LocalTransport()
    stores = [open_store() for _ in range(num_hosts)]
    caches = [
        TieredCache(
            stores[h].lengths(), budget_bytes // num_hosts, policy=policy
        )
        for h in range(num_hosts)
    ]
    placement = ClairvoyantPlacement(
        shuffler,
        num_hosts,
        [c.capacity for c in caches],
        policy=policy,
        max_epochs=max_epochs,
    )
    nodes = []
    for h in range(num_hosts):
        transport.register(h, caches[h])
        view = HostShardView(shuffler, num_hosts, h)
        remote = RemoteTier(h, placement, RemoteFetcher(transport, h, retry))
        fetcher = PrefetchingFetcher(
            stores[h],
            view,
            lookahead=lookahead,
            mode=mode,
            gap_bytes=gap_bytes,
            workers=workers,
            background=background,
            start_epoch=start_epoch,
            max_epochs=max_epochs,
            cache=caches[h],
            policy=policy,
            planner=planner,
            remote=remote if num_hosts > 1 else None,
            placement=placement if num_hosts > 1 else None,
        )
        if num_hosts > 1:
            # retention pushes land in the receiver's inbox and are
            # drained between its batches — never inserted mid-serve
            transport.register_inbox(h, fetcher._inbox_put)
        nodes.append(HostNode(h, stores[h], view, caches[h], remote, fetcher))
    return Cluster(nodes, placement, transport)


__all__ = [
    "Cluster",
    "ClusterFetcher",
    "HostNode",
    "RemoteFetcher",
    "RemoteTier",
    "copy_records",
    "make_cluster",
]
