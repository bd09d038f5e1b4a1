"""Clairvoyant record placement for the multi-host tier (distributed LIRS;
the port's copy of ``repro.sharding.placement``, numpy only).

LIRS makes every epoch's access order a known permutation; NoPFS-style
distribution ("Clairvoyant Prefetching for Distributed ML I/O",
PAPERS.md) observes that the same clairvoyance solves *placement* across
hosts, not just eviction within one.  The stream is consumed in shards —
host ``h`` of ``H`` owns a fixed slot range of every global batch (the
:class:`~repro_torch.core.sampler.ShardedSampler` rule, communication-free) —
and each host runs a :class:`~repro_torch.prefetch.cache.TieredCache` over the
records *it* consumes.  A record consumed this epoch and retained is
served next epoch host-to-host instead of re-read from storage: a
cross-host tier below DRAM, above NVM.

The placement rule is closed-form, derived from exact next-use
positions (the same pigeonhole argument that made Belady ``hit = c``
exact):

* **who caches** — the *next consumer* caches: record ``r``, consumed
  in epoch ``e`` by host ``h`` and due on host ``g`` in epoch ``e+1``,
  is retained by ``g`` — ``h`` hands the bytes over at ``r``'s epoch-e
  use (a push, overlapped with compute), and ``g``'s epoch-``e+1`` use
  is then a local DRAM hit.  The holder table is a pure function of
  epoch ``e+1``'s permutation and the slot bounds — every host computes
  it locally, no directory service, no communication.  Retaining on the
  *source* consumer instead (the natural first guess) is infeasible:
  mid-epoch, a host's not-yet-consumed old winners coexist with its
  already-consumed new winners and the joint set overflows
  ``capacity_h`` by up to ~``capacity_h/2`` — records get evicted or
  declined, and every loss is one storage read above the floor.
* **what is retained** — among the records host ``g`` will consume in
  epoch ``e+1``, the ``capacity_g`` with the *soonest* epoch-``e+1``
  use (``g``'s stream head) win; the rest are not worth a slot
  anywhere.  This choice makes the per-host occupancy trajectory
  feasible *by construction*: ``g``'s old winners are its epoch-``e``
  stream head — consumed (and freed) at the full local consumption rate
  early in the epoch — while new winners trickle in at the fleet
  consumption rate scaled by ``capacity_g/n``, so departures always
  lead arrivals and occupancy never exceeds ``capacity_g``.  Every
  retained record is reused exactly once next epoch, so aggregate
  avoided storage reads are exactly ``sum(capacity_h)`` per epoch — the
  fleet reads ``(1 − c_global) · n`` records/epoch, the distributed
  pigeonhole, and hits it *exactly*.

The rule is *advisory*: the live per-host tiers enforce capacity with
their own admission exchange, and a consumer whose placement lookup
answers "host g" simply asks ``g`` — a peer miss (eviction drift, skew)
falls back to one storage read, never corrupts a batch.  The
:class:`~repro_torch.storage.page_cache.DistributedCacheSim` record-level
simulator validates the closed forms in
:func:`repro_torch.storage.devices.distributed_hit_model` against these exact
dynamics.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

NO_HOST = -1


def host_slice_bounds(batch_len: int, num_hosts: int) -> np.ndarray:
    """Slot bounds of one global batch: host ``h`` consumes
    ``batch[bounds[h]:bounds[h+1]]``.  Matches
    :meth:`repro_torch.core.sampler.ShardedSampler._even_bounds` so the data
    plane and the (metadata-only) sampler agree on ownership; short
    remainder batches split proportionally."""
    return np.linspace(0, batch_len, num_hosts + 1).astype(np.int64)


class HostShardView:
    """Host ``h``'s view of a global shuffler.

    ``epoch_batches`` yields only the slice this host consumes of each
    global batch — the per-host substream the local pipeline serves —
    while ``epoch_index_stream`` stays **global**, so a
    :class:`~repro_torch.prefetch.scheduler.LookaheadScheduler` built over the
    view prices every record at its *global* next-use position.  That is
    what makes per-host Belady eviction exact fleet-wide: a resident's
    reuse may be on another host, and the eviction priority must say so.
    """

    def __init__(self, shuffler, num_hosts: int, host_id: int):
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        self.shuffler = shuffler
        self.num_hosts = int(num_hosts)
        self.host_id = int(host_id)
        self.num_items = shuffler.num_items

    def epoch_batches(self, epoch: int) -> Iterator[np.ndarray]:
        h = self.host_id
        for batch in self.shuffler.epoch_batches(epoch):
            b = host_slice_bounds(len(batch), self.num_hosts)
            yield np.asarray(batch, np.int64)[b[h] : b[h + 1]]

    def epoch_index_stream(self, epoch: int) -> np.ndarray:
        """The GLOBAL epoch access order (all hosts interleaved) — the
        coordinate system for clairvoyant next-use priorities."""
        return self.shuffler.epoch_index_stream(epoch)

    def host_epoch_stream(self, epoch: int) -> np.ndarray:
        """This host's consumption order (concatenated slices)."""
        parts = list(self.epoch_batches(epoch))
        if not parts:
            return np.empty(0, np.int64)
        return np.concatenate(parts)


class ClairvoyantPlacement:
    """Closed-form ``record → caching host`` tables, one per epoch.

    ``holder_after(e)[r]`` answers: after epoch ``e`` is consumed, which
    host retains record ``r`` for its epoch ``e+1`` use (``NO_HOST``
    when nobody should).  Consumers serving epoch ``e`` look up
    ``peer_for(ids, e)`` = ``holder_after(e − 1)`` — the host that
    consumed each record last epoch *and* won the retention rank.

    ``capacities[h]`` is host ``h``'s cache capacity in records; the
    Belady retention rule keeps, per *epoch-``e+1`` consuming* host, the
    ``capacity_h`` records with the soonest epoch-``e+1`` use — the
    host's next-epoch stream head (ties broken by record id via the
    stable sort, so every host computes the identical table).  With
    ``policy="lru"`` the rank filter is skipped — recency retention has
    no closed-form membership, so every record's epoch-``e`` consumer is
    a *candidate* holder and the peer answers the actual hit/miss.
    """

    def __init__(
        self,
        shuffler,
        num_hosts: int,
        capacities: Sequence[int],
        policy: str = "belady",
        max_epochs: Optional[int] = None,
    ):
        if len(capacities) != num_hosts:
            raise ValueError("need one capacity per host")
        self.shuffler = shuffler
        self.num_hosts = int(num_hosts)
        self.capacities = [int(c) for c in capacities]
        self.policy = policy
        self.max_epochs = max_epochs
        self.num_items = shuffler.num_items
        self._consumer: Dict[int, np.ndarray] = {}
        self._holder: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------- tables
    def consumer_table(self, epoch: int) -> np.ndarray:
        """``out[r]`` = host consuming record ``r`` in ``epoch`` (int8
        won't do — hosts can exceed 127 in principle — int32)."""
        tbl = self._consumer.get(epoch)
        if tbl is None:
            tbl = np.full(self.num_items, NO_HOST, np.int32)
            for batch in self.shuffler.epoch_batches(epoch):
                batch = np.asarray(batch, np.int64)
                b = host_slice_bounds(len(batch), self.num_hosts)
                for h in range(self.num_hosts):
                    tbl[batch[b[h] : b[h + 1]]] = h
            self._consumer[epoch] = tbl
            self._prune(self._consumer, epoch)
        return tbl

    def holder_after(self, epoch: int) -> np.ndarray:
        """``out[r]`` = host retaining ``r`` from its epoch-``epoch`` use
        to its epoch-``epoch+1`` use, ``NO_HOST`` if not retained."""
        if epoch < 0:
            return np.full(self.num_items, NO_HOST, np.int32)
        if self.max_epochs is not None and epoch + 1 >= self.max_epochs:
            # nothing after the last epoch: retention serves nobody
            return np.full(self.num_items, NO_HOST, np.int32)
        tbl = self._holder.get(epoch)
        if tbl is None:
            if self.policy == "belady":
                # consumer-side retention: the record's epoch-e+1
                # consumer holds it, and per host the capacity_h
                # soonest-used records of its e+1 stream (its head) win
                # — the unique rank choice whose per-host occupancy
                # trajectory stays within capacity for the whole epoch
                tbl = self.consumer_table(epoch + 1).copy()
                nxt = np.asarray(
                    self.shuffler.epoch_index_stream(epoch + 1), np.int64
                )
                next_pos = np.empty(self.num_items, np.int64)
                next_pos[nxt] = np.arange(len(nxt), dtype=np.int64)
                for h in range(self.num_hosts):
                    members = np.flatnonzero(tbl == h)
                    k = self.capacities[h]
                    if len(members) > k:
                        order = np.argsort(next_pos[members], kind="stable")
                        tbl[members[order[k:]]] = NO_HOST
            else:
                tbl = self.consumer_table(epoch).copy()
            self._holder[epoch] = tbl
            self._prune(self._holder, epoch)
        return tbl

    def peer_for(self, ids: np.ndarray, epoch: int) -> np.ndarray:
        """For records about to be consumed in ``epoch``: the predicted
        holding peer of each (``NO_HOST`` = read storage).  A host's own
        id can appear — local retention — which the caller's DRAM gather
        already served; routing treats it as no-peer."""
        ids = np.asarray(ids, np.int64)
        return self.holder_after(epoch - 1)[ids]

    def _prune(self, table: Dict[int, np.ndarray], epoch: int):
        for e in [e for e in table if e < epoch - 2]:
            del table[e]

    # ------------------------------------------------------------- models
    def aggregate_capacity(self) -> int:
        return int(sum(self.capacities))

    def expected_storage_reads(self, steady: bool = True) -> int:
        """Per-epoch storage reads the fleet should issue in steady state
        (from epoch 2 on): the distributed pigeonhole floor
        ``n − sum(capacity_h)``, clamped at 0."""
        if not steady:
            return self.num_items
        return max(0, self.num_items - self.aggregate_capacity())
