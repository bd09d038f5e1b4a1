"""Clairvoyant lookahead planning over a shuffler's future index stream.

LIRS (and BMF/TFIP) generate the whole epoch's batch sequence from a few
integers, so the scheduler can walk arbitrarily far ahead of the batch
the trainer is consuming — including across epoch boundaries, where the
*next* epoch's permutation is equally known.  It maintains a sliding
window of the next ``lookahead`` batches and, as each batch is admitted,
emits a :class:`PrefetchPlan` naming exactly the records storage must
produce for it:

* records already resident in the :class:`~repro_torch.prefetch.cache.TieredCache`
  are *window hits* — no fetch, and the admission pins them so eviction
  cannot take them before use (known reuse distance → retention);
* records already planned by an earlier batch still inside the window
  are deduplicated — a record is fetched at most once per window;
* everything else becomes the plan's ``fetch`` array, coalesced later by
  the record store's shared ``_sorted_plan`` cut rule.

The **policy-aware planner** (``planner=True``, the default whenever the
tier evicts by Belady) adds an occupancy simulation on top: the
scheduler replays the cache's admission decision forward along the index
stream it already knows, and drops *doomed* records from plans — records
whose simulated residency would end before their use (no slot will exist
for them once the window's pinned working set is accounted), which the
unplanned path would read, fail to insert, and read again on demand.
Doomed records are counted in ``doomed_records`` and left to the demand
path as *expected misses* (read exactly once, admission-filtered at
insert).  The planner also prices every planned record's *upcoming use*
position and every served record's *next-epoch* position
(:meth:`next_use_after`), so the cache's admission exchange runs on
exact clairvoyant priorities rather than arrival order.

The scheduler is pure bookkeeping (no threads, no I/O): the
:class:`~repro_torch.prefetch.fetcher.PrefetchingFetcher` drives it and
executes its plans.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.obs import trace as _trace
from repro_torch.prefetch.cache import NEVER, TieredCache


def batch_key(batch: np.ndarray) -> Tuple[int, ...]:
    """Cheap fingerprint identifying a batch inside the window (length +
    first/middle/last records).  Collisions between two simultaneously
    live batches are astronomically unlikely and only cost a redundant
    read, never correctness — mismatches fall back to head retirement /
    the demand miss path."""
    n = len(batch)
    if n == 0:
        return (0,)
    return (n, int(batch[0]), int(batch[n // 2]), int(batch[-1]))


@dataclasses.dataclass
class PrefetchPlan:
    """What storage must produce before one future batch is served."""

    epoch: int
    seq: int                 # batch sequence number within the epoch
    batch: np.ndarray        # the batch's record indices, as yielded
    fetch: np.ndarray        # deduplicated subset that needs a storage read
    fetch_bytes: int         # payload bytes the fetch will bring in
    # the planner's admission priority for each fetch record: the
    # absolute stream position of its next use *after* the window use it
    # is being prefetched for (its retention merit — the window use
    # itself is protected by the pin).  None when the planner is off or
    # the shuffler exposes no index stream.
    use_pos: Optional[np.ndarray] = None
    # clairvoyant routing for each fetch record (multi-host tier): the
    # host predicted to hold it (its previous-epoch consumer that won the
    # retention rank — ``ClairvoyantPlacement.peer_for``), ``NO_HOST``
    # (-1) = read storage.  None when no placement is attached.
    peer: Optional[np.ndarray] = None


class LookaheadScheduler:
    """Sliding window of the next ``lookahead`` batches of a shuffler.

    ``advance()`` retires the oldest (just-served) batch and admits the
    next future one; ``fill()`` / ``start_epoch()`` prime or re-sync the
    window.  Pin bookkeeping against the cache mirrors window membership
    exactly: every admitted batch pins its distinct records once, every
    retirement unpins them.
    """

    def __init__(
        self,
        shuffler,
        cache: Optional[TieredCache] = None,
        lookahead: int = 8,
        start_epoch: int = 0,
        max_epochs: Optional[int] = None,
        record_lengths: Optional[np.ndarray] = None,
        planner: Optional[bool] = None,
        placement=None,
    ):
        self.shuffler = shuffler
        self.cache = cache
        # a ClairvoyantPlacement (the multi-host tier's, not in the port
        # yet: build_data_plane refuses one) or None: when set, every
        # plan's fetch records are annotated with their predicted holding
        # peer, so the executor asks a host instead of storage — exact
        # next-use positions driving *routing*, the same closed form that
        # drives eviction
        self.placement = placement
        self.lookahead = max(1, int(lookahead))
        self.max_epochs = max_epochs
        if record_lengths is not None:
            self._lengths = np.asarray(record_lengths, np.int64)
        elif cache is not None:
            self._lengths = cache.record_lengths
        else:
            self._lengths = None
        # per-record membership count of the current window (dedup + pins)
        self._window_count = np.zeros(shuffler.num_items, np.int32)
        # Belady bookkeeping: when the cache evicts farthest-next-use, the
        # scheduler feeds it exact next-use stream positions — LIRS's
        # clairvoyance means they are *known*, not estimated.  A record's
        # next use after being served in epoch e is its position in epoch
        # e+1's index stream; one inverse-permutation array per epoch
        # (cached, pruned as the window moves on) prices every retirement
        # with a single vectorized take.
        self._track_next_use = (
            cache is not None
            and getattr(cache, "policy", "lru") == "belady"
            and hasattr(shuffler, "epoch_index_stream")
        )
        # the policy-aware planner: simulate the admission decision at
        # plan time and drop doomed records.  Default on exactly when the
        # simulation can be exact — a Belady tier fed by a clairvoyant
        # index stream; explicit planner=True on an lru tier still gets
        # the occupancy cap (admission there is a capacity check only).
        if planner is None:
            planner = self._track_next_use
        self.planner = bool(planner) and cache is not None
        # placement-routed belady tier: every planned read is *staged*
        # by the executor in a window-lifetime side buffer instead of
        # inserted into the cache — the slice of DRAM
        # ``IOPlan.prefetch_window_bytes`` already models separately
        # from ``cache_budget_bytes``.  The cache then holds retention
        # winners only, populated at retirement by the serve path's
        # push-to-next-holder, so physical occupancy follows the
        # placement's (feasible) trajectory.  Without staging, pinned
        # window reads squeeze retention capacity mid-epoch and
        # evict/decline placement-predicted winners; at H=1 that
        # displacement is count-neutral (any retained record is locally
        # gathered at its next use), but across hosts a lost winner is
        # one storage read above the pigeonhole floor.
        self._stage_floor = (
            self.planner and self._track_next_use and placement is not None
        )
        self._epoch_pos: Dict[int, np.ndarray] = {}
        self._pinned = 0       # distinct records currently pinned, summed
        # simulated pinned-slot occupancy: for every live window batch,
        # the records that will sit pinned in the cache for it (resident
        # at admission + planned fetches).  What remains of ``capacity``
        # is the room a plan's insert will actually find.
        self._sim_occupancy = 0
        self._pending: Optional[Tuple[int, int, np.ndarray]] = None
        self.primed = False
        # admission-time accounting: a "window hit" is a record that was
        # already resident when its batch entered the window, i.e. an
        # epoch storage read the DRAM tier avoided
        self.admitted_records = 0
        self.window_hits = 0
        self.window_hit_bytes = 0
        self.planned_records = 0
        self.planned_bytes = 0
        # records the planner dropped from plans at plan time (doomed:
        # the occupancy simulation found no slot for them) — still
        # charged as storage reads in ``planned_records`` (the demand
        # path reads them once), tracked separately for visibility
        self.doomed_records = 0
        self.doomed_bytes = 0
        self._window: deque = deque()
        self._stream: Iterator[Tuple[int, int, np.ndarray]] = self._gen(
            start_epoch
        )

    # ------------------------------------------------------------- stream
    def _gen(self, epoch0: int) -> Iterator[Tuple[int, int, np.ndarray]]:
        e = epoch0
        while self.max_epochs is None or e < self.max_epochs:
            for seq, batch in enumerate(self.shuffler.epoch_batches(e)):
                yield e, seq, np.asarray(batch, np.int64)
            e += 1

    @property
    def head(self) -> Optional[Tuple[int, int]]:
        """(epoch, seq) of the next batch the demand side will consume."""
        return self._window[0][:2] if self._window else None

    @property
    def window_records(self) -> int:
        """Distinct records currently pinned by the window — the slice of
        the cache budget the prefetch working set occupies (what
        ``IOPlan``'s ``prefetch_window_bytes`` models)."""
        return self._pinned

    @property
    def hit_rate(self) -> float:
        """Fraction of admitted records that needed no storage read: the
        avoided-I/O notion ``IOPlan.cache_hit_fraction`` models (window
        dedups count as hits — their one read is charged to the first
        occurrence)."""
        if not self.admitted_records:
            return 0.0
        return 1.0 - self.planned_records / self.admitted_records

    # ------------------------------------------------------------- window
    def _pin_limit(self) -> Optional[int]:
        """How many distinct records the window may pin at once.

        Half the cache capacity: the window is the prefetch working set
        (records land pinned, stay until served), and letting it flood
        the whole tier leaves no slots for cross-epoch LRU retention —
        worse, prefetched records start getting *rejected* and every
        batch is read twice.  No cache → no limit (planning is free).
        """
        if self.cache is None:
            return None
        return max(0, self.cache.capacity // 2)

    def _admit_item(self, epoch, seq, batch, uniq) -> PrefetchPlan:
        fresh = uniq[self._window_count[uniq] == 0]
        if self.cache is not None and self.cache.capacity > 0:
            hit = self.cache.resident(fresh)
            resident, fetch = fresh[hit], fresh[~hit]
        elif self.cache is not None:
            # 0-capacity tier: nothing can be retained, so prefetching
            # would only read every record twice — plan nothing
            resident, fetch = fresh[:0], fresh[:0]
        else:
            resident, fetch = fresh[:0], fresh
        planned = fetch
        limit = self._pin_limit()
        if limit is not None:
            # a single batch wider than the pin budget (window-empty
            # admission) must not prefetch more than the tier can hold —
            # the overflow would be read, rejected by insert, and read
            # again on demand; leave it to the (single) demand read
            planned = planned[: max(0, limit - self._pinned)]
        use_pos = None
        stage = None
        if self._stage_floor and len(planned):
            # placement-routed tier: *every* planned read is staged in
            # the executor's window side buffer, never inserted at plan
            # time.  Retention happens at retirement — the serve path
            # pushes each consumed record to its predicted next-epoch
            # holder (possibly itself) — so cache arrivals track the
            # placement's occupancy trajectory exactly; plan-time
            # inserts would land up to ``lookahead`` batches early and
            # overflow the tier right at the epoch boundary, where
            # occupancy legitimately peaks at capacity.
            use_pos = self._retention_pos(planned, epoch)
            stage = np.ones(len(planned), bool)
        if self.planner:
            # occupancy simulation: every live plan's cache insert lands
            # pinned, so the room this plan's insert will find is
            # capacity minus the window's simulated pinned-slot
            # footprint.  Anything beyond it is doomed — read, declined
            # (or rejected) at insert, and read again on demand — so it
            # is dropped here and served by the (single,
            # admission-filtered) demand read.
            room = max(0, self.cache.capacity - self._sim_occupancy)
            if stage is None:
                planned = planned[:room]
                if use_pos is not None:
                    use_pos = use_pos[:room]
            else:
                cache_bound = np.flatnonzero(~stage)
                if len(cache_bound) > room:
                    keep = np.ones(len(planned), bool)
                    keep[cache_bound[room:]] = False
                    planned = planned[keep]
                    use_pos, stage = use_pos[keep], stage[keep]
            if len(planned) < len(fetch):
                self.doomed_records += len(fetch) - len(planned)
                if self._lengths is not None:
                    self.doomed_bytes += int(
                        self._lengths[fetch].sum()
                        - self._lengths[planned].sum()
                    )
        self._window_count[uniq] += 1
        self._pinned += len(uniq)
        if self.cache is not None:
            self.cache.pin(uniq)
        self.admitted_records += len(batch)
        self.window_hits += len(resident)
        if self._lengths is not None:
            self.window_hit_bytes += int(self._lengths[resident].sum())
        # overflow records are still storage reads (by the demand path),
        # so the avoided-I/O accounting charges the full fetch set
        self.planned_records += len(fetch)
        if self._lengths is not None:
            self.planned_bytes += int(self._lengths[fetch].sum())
        if self.planner and self._track_next_use and len(planned):
            # the doom rule proper: price each candidate at its *post-use*
            # reuse (its position in the next epoch's stream, placement-
            # masked) and replay the cache's admission exchange on that
            # priority.  A loser's simulated residency ends right after
            # its pinned window use — it would displace a resident with a
            # *sooner* reuse (a future retention hit) only to be evicted
            # before its own — so it is dropped from the plan and
            # demand-read exactly once (with staging on, losers bypass
            # the cache entirely and are never doomed).  Winners carry
            # the same priority into the insert, which re-runs the
            # identical exchange under the cache lock.
            if use_pos is None:
                use_pos = self._retention_pos(planned, epoch)
            probe = (
                np.arange(len(planned), dtype=np.int64)
                if stage is None
                else np.flatnonzero(~stage)
            )
            if len(probe):
                ok = self.cache.admit(planned[probe], next_use=use_pos[probe])
                if not ok.all():
                    self.doomed_records += int((~ok).sum())
                    if self._lengths is not None:
                        self.doomed_bytes += int(
                            self._lengths[planned[probe[~ok]]].sum()
                        )
                    keep = np.ones(len(planned), bool)
                    keep[probe[~ok]] = False
                    planned, use_pos = planned[keep], use_pos[keep]
                    if stage is not None:
                        stage = stage[keep]
        occ = len(resident) + (
            len(planned) if stage is None else int((~stage).sum())
        )
        self._sim_occupancy += occ
        nbytes = (
            int(self._lengths[planned].sum())
            if self._lengths is not None
            else 0
        )
        peer = None
        if self.placement is not None and len(planned):
            peer = self.placement.peer_for(planned, epoch)
        self._window.append((epoch, seq, uniq, batch_key(batch), occ))
        return PrefetchPlan(epoch, seq, batch, planned, nbytes, use_pos, peer)

    def _top_up(self) -> List[PrefetchPlan]:
        """Admit batches until the window holds ``lookahead`` of them, the
        pin limit is reached, or the stream ends."""
        with _trace.span("cache/plan", "cache"):
            return self._top_up_impl()

    def _top_up_impl(self) -> List[PrefetchPlan]:
        plans: List[PrefetchPlan] = []
        limit = self._pin_limit()
        while len(self._window) < self.lookahead:
            item = self._pending
            self._pending = None
            if item is None:
                item = next(self._stream, None)
            if item is None:
                break
            epoch, seq, batch = item
            uniq = np.unique(batch)
            if (
                limit is not None
                and self._window
                and self._pinned + len(uniq) > limit
            ):
                self._pending = item  # window is as deep as the tier allows
                break
            plans.append(self._admit_item(epoch, seq, batch, uniq))
        return plans

    def _next_epoch_pos(self, epoch: int) -> Optional[np.ndarray]:
        """Inverse position table of ``epoch``'s index stream
        (``pos[record] = position within the epoch``), or ``None`` when
        the stream never reaches that epoch.  Cached per epoch; stale
        epochs are pruned so at most a handful of tables are live."""
        if self.max_epochs is not None and epoch >= self.max_epochs:
            return None
        tbl = self._epoch_pos.get(epoch)
        if tbl is None:
            stream = np.asarray(
                self.shuffler.epoch_index_stream(epoch), np.int64
            )
            tbl = np.empty(self.shuffler.num_items, np.int64)
            tbl[stream] = np.arange(len(stream), dtype=np.int64)
            self._epoch_pos[epoch] = tbl
            for e in [e for e in self._epoch_pos if e < epoch - 2]:
                del self._epoch_pos[e]
        return tbl

    def _retention_pos(self, ids: np.ndarray, epoch: int) -> np.ndarray:
        """Post-use Belady priorities for records just consumed in
        ``epoch``: each one's absolute position in epoch ``epoch + 1``'s
        stream — **placement-masked**.  With a placement attached, a
        consumed record is only ever asked of this host again if the
        placement predicts this host as its next holder
        (``holder_after(epoch) == host_id``); a rank-filter loser will be
        demanded from storage (nobody routes to us), so pricing it at its
        true global reuse would make the local tier retain bytes no
        consumer will request — crowding out the marginal winners the
        routing *does* send here, which is exactly the divergence that
        pushed fleet reads above the pigeonhole floor.  Losers price at
        ``NEVER``: first eviction victims, and they lose every admission
        exchange against a real winner."""
        ids = np.asarray(ids, np.int64)
        tbl = self._next_epoch_pos(epoch + 1)
        if tbl is None:
            return np.full(len(ids), NEVER, np.int64)
        pos = (epoch + 1) * self.shuffler.num_items + tbl[ids]
        host = getattr(self.shuffler, "host_id", None)
        if self.placement is not None and host is not None:
            pos = np.where(
                self.placement.holder_after(epoch)[ids] == host, pos, NEVER
            )
        return pos

    def _retire(
        self, key: Optional[Tuple[int, ...]] = None, served: bool = True
    ):
        """Retire the window entry matching ``key`` (the batch that was
        actually served — under multi-producer pipelines fetches complete
        out of order, and retiring the head would unpin a *different*,
        still-unserved batch); no match or no key retires the head.
        ``served=False`` (a :meth:`reset`) skips the next-use update: the
        batch was abandoned, its records were not consumed."""
        if not self._window:
            return
        pos = 0
        if key is not None:
            for j, entry in enumerate(self._window):
                if entry[3] == key:
                    pos = j
                    break
        epoch, _, uniq, _, occ = self._window[pos]
        del self._window[pos]
        self._window_count[uniq] -= 1
        self._pinned -= len(uniq)
        self._sim_occupancy -= occ
        if self.cache is not None:
            self.cache.unpin(uniq)
            if served and self._track_next_use:
                # the batch's records were just used; each one's next use
                # is its (known) position in the next epoch's permutation,
                # placement-masked so only records routed back to this
                # host keep a retention priority
                self.cache.note_next_use(
                    uniq, self._retention_pos(uniq, epoch)
                )

    def next_use_after(
        self, indices: np.ndarray, key: Optional[Tuple[int, ...]] = None
    ) -> Optional[np.ndarray]:
        """Post-use Belady priorities for a batch being *served*: each
        record's absolute position in the following epoch's stream
        (``NEVER`` when the stream ends first), aligned with ``indices``.
        The admission-filtered demand insert runs its exchange on these,
        so a record only displaces a resident whose reuse is farther.
        Placement-masked (:meth:`_retention_pos`): records this host is
        not predicted to hold next epoch price at ``NEVER``.  The batch's
        epoch comes from its window entry (by ``key``, falling back to
        the head); ``None`` when clairvoyant positions are unavailable
        (no Belady tier, or no index stream)."""
        if not self._track_next_use or not self._window:
            return None
        k = key if key is not None else batch_key(indices)
        epoch = self._window[0][0]
        for entry in self._window:
            if entry[3] == k:
                epoch = entry[0]
                break
        return self._retention_pos(np.asarray(indices, np.int64), epoch)

    def epoch_of(self, key: Optional[Tuple[int, ...]]) -> Optional[int]:
        """Epoch of the window entry matching ``key`` (falling back to the
        head) — what the demand serve path needs to *route* a miss to its
        predicted peer (placement tables are per-epoch coordinates)."""
        if not self._window:
            return None
        if key is not None:
            for entry in self._window:
                if entry[3] == key:
                    return entry[0]
        return self._window[0][0]

    def push_spec(
        self, ids: np.ndarray, epoch: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Retention handoff for a batch just consumed in ``epoch``:
        ``(holder, next_use)`` aligned with ``ids`` — each record's
        predicted epoch-``epoch+1`` holder (``NO_HOST`` = retained
        nowhere) and its absolute next-epoch stream position, the Belady
        priority the receiving cache admits it under.  ``None`` when no
        placement is attached or the stream ends after ``epoch`` (last
        epoch: nothing to hand over)."""
        if self.placement is None:
            return None
        tbl = self._next_epoch_pos(epoch + 1)
        if tbl is None:
            return None
        ids = np.asarray(ids, np.int64)
        hold = self.placement.holder_after(epoch)[ids]
        pos = (epoch + 1) * self.shuffler.num_items + tbl[ids]
        return hold, pos

    def fill(self) -> List[PrefetchPlan]:
        """Prime the window; returns the new plans in admission order."""
        self.primed = True
        return self._top_up()

    def advance(self, batch: Optional[np.ndarray] = None) -> List[PrefetchPlan]:
        """One batch was served: retire it (by identity when ``batch`` is
        given, else the window head), slide the window ahead."""
        self._retire(batch_key(batch) if batch is not None else None)
        return self._top_up()

    def start_epoch(self, epoch: int) -> List[PrefetchPlan]:
        """Position the window at ``(epoch, 0)``.

        A no-op (returns ``[]``) when the stream is already there — the
        common case of epochs consumed back-to-back, where the window has
        legitimately crossed the boundary ahead of demand.  Anything else
        (first use, an abandoned epoch, epoch replay) resets and refills.
        """
        if self.primed and self.head == (epoch, 0):
            return []
        self.reset(epoch)
        return self.fill()

    def reset(self, epoch: int):
        """Drop the window (unpinning everything) and restart the stream
        at ``(epoch, 0)``.  Cache contents survive — only planning state
        resets."""
        while self._window:
            self._retire(served=False)
        self._window_count[:] = 0
        self._pinned = 0
        self._sim_occupancy = 0
        self._pending = None
        self._epoch_pos.clear()
        if self._track_next_use:
            # next-use positions are absolute coordinates of the *old*
            # stream; replaying an epoch restarts the coordinate system,
            # and stale far-future values would make records with
            # imminent uses look like the best victims.  NEVER = "prove
            # your next use again" — each record re-prices at its first
            # post-reset retirement
            self.cache.note_next_use(
                np.arange(self.shuffler.num_items, dtype=np.int64), NEVER
            )
        self._stream = self._gen(epoch)
        self.primed = False
