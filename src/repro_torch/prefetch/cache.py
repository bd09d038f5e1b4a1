"""Byte-budgeted DRAM record cache (the tier above NVM).

The cache is a *slot arena*: ``capacity`` fixed-width slots in one
preallocated uint8 matrix, where slot width is the store's largest record
payload.  ``capacity * slot_bytes`` never exceeds the byte budget, so the
budget bounds resident bytes by construction.  All bookkeeping is NumPy
arrays indexed by record id — residency, LRU ticks, next-use positions,
pin counts — so a 4096-record batch is served, filled, or evicted with a
handful of vectorized passes and zero per-record Python, matching the
batch engines' performance discipline (a dict-of-bytes cache would hand
the per-record cost the arena engines eliminated right back).

Eviction is policy-selectable:

* ``lru`` — LRU **by batch**: every gather/insert advances one logical
  tick shared by all records it touched, and eviction takes the unpinned
  residents with the smallest tick.
* ``belady`` — farthest-next-use (Belady's MIN): eviction takes the
  unpinned residents with the *largest* ``next_use`` stream position — a
  vectorized argmax/argpartition over the candidates, heap-free.  The
  positions come from the clairvoyant scheduler, which knows every future
  use because LIRS permutes indexes (``note_next_use``); a record whose
  next use is unknown carries ``NEVER`` and is evicted first.

Pinning is orthogonal to the policy: records inside the lookahead window
(i.e. about to be used) carry a pin count and are never evicted, no
matter how stale their tick or how far their next use.

Admission is the policy's other half (the prefetch *planner*'s hook):
an unfiltered ``insert`` accepts incoming records in arrival order and
only then lets eviction pick victims — under ``belady`` that admits a
far-future record by evicting a sooner-use resident, which forfeits the
retention the closed forms promise and, when every victim is pinned,
shows up as ``rejected`` inserts.  ``admit()`` answers, without copying
a byte, which of a candidate set an admission-filtered insert would
retain (free slots first, then strictly-sooner-next-use exchanges
against evictable residents); ``insert(..., filtered=True)`` applies
the same rule under one lock and counts the records it declines in
``planned_skips`` — a *decision*, distinct from the ``rejected``
counter, which keeps meaning "insert wanted a slot and none existed".

Thread safety: one lock around every public method.  Gathers copy out
under the lock, so a concurrent insert/evict can never recycle a slot
mid-copy.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from repro_torch.obs import trace as _trace
from repro_torch.storage.devices import EVICTION_POLICIES

# "no known future use": sorts after every real stream position, so
# unknown records are the first Belady victims
NEVER = np.iinfo(np.int64).max


def copy_records(
    src: np.ndarray,
    src_off: np.ndarray,
    dst: np.ndarray,
    dst_off: np.ndarray,
    lens: np.ndarray,
):
    """Vectorized multi-record memcpy between flat uint8 buffers:
    ``dst[dst_off[i] : dst_off[i]+lens[i]] = src[src_off[i] : ...]`` for
    every record ``i`` — one repeat/iota pass, no per-record Python."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return
    starts = np.concatenate(([0], np.cumsum(lens[:-1])))
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
    dst[np.repeat(np.asarray(dst_off, np.int64), lens) + within] = src[
        np.repeat(np.asarray(src_off, np.int64), lens) + within
    ]


class TieredCache:
    """DRAM tier over a :class:`~repro_torch.storage.record_store.RecordStore`.

    ``record_lengths`` are the store's per-record *payload* lengths
    (``store.lengths()``); they fix each record's slot usage and let both
    sides agree on byte counts.  ``budget_bytes`` caps the arena:
    ``nbytes <= budget_bytes`` always, and a budget smaller than one slot
    degenerates to a 0-capacity cache that misses everything (still
    byte-identical behaviour, just no hits).  ``policy`` selects the
    eviction rule (``lru`` or ``belady``); batch bytes are identical
    either way — only *which* records stay resident changes.
    """

    def __init__(
        self,
        record_lengths: np.ndarray,
        budget_bytes: int,
        slot_bytes: Optional[int] = None,
        policy: str = "lru",
    ):
        if policy not in EVICTION_POLICIES:
            raise ValueError(
                f"policy must be one of {EVICTION_POLICIES}, got {policy!r}"
            )
        lengths = np.asarray(record_lengths, np.int64)
        self.record_lengths = lengths
        self.policy = policy
        n = len(lengths)
        if slot_bytes is None:
            slot_bytes = int(lengths.max()) if n else 1
        self.slot_bytes = max(1, int(slot_bytes))
        self.budget_bytes = int(budget_bytes)
        self.capacity = max(0, self.budget_bytes // self.slot_bytes)
        self._arena = np.empty(self.capacity * self.slot_bytes, np.uint8)
        self._slot_of = np.full(n, -1, np.int64)   # record id -> slot (-1 absent)
        self._id_of = np.full(self.capacity, -1, np.int64)  # slot -> record id
        self._free = list(range(self.capacity))
        self._pin = np.zeros(n, np.int32)
        self._last_used = np.zeros(n, np.int64)
        # record id -> stream position of its next use (Belady priority);
        # written by the scheduler's retirement bookkeeping, read at
        # eviction time.  LRU caches never consult it.
        self.next_use = np.full(n, NEVER, np.int64)
        self._tick = 0
        self._used_bytes = 0
        self._lock = threading.Lock()
        # gather-level counters (records served / missed at demand time)
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.insertions = 0
        self.evictions = 0
        self.rejected = 0  # inserts dropped because every victim was pinned
        # records an admission-filtered insert *chose* not to cache —
        # skipped by decision, not by slot starvation; the demand path
        # reads them exactly once and moves on.  Each filtered insert's
        # decline counts once here; earlier trims of the same record
        # (plan-time dooms, execute-time probe skips) are counted at
        # their own sites (scheduler.doomed_records, fetcher.probe_skips)
        self.planned_skips = 0
        self.planned_skip_bytes = 0
        self.stray_unpins = 0  # unpins without a matching pin (a pairing bug)
        self.invalidations = 0  # residents dropped by invalidate()
        # copies the serve path routed through an intermediate buffer
        # instead of the final destination (ring slot / caller buffer) —
        # the zero-copy handoff keeps these at 0 for fully-resident and
        # fully-missed batches
        self.scratch_copies = 0
        self.scratch_copy_bytes = 0
        # cross-host tier supply side: records/bytes exported to peers by
        # export_records(), and how many of those were released (moved,
        # not copied — consumer-caches placement)
        self.remote_served = 0
        self.remote_served_bytes = 0
        self.remote_released = 0

    # ---------------------------------------------------------- introspect
    @property
    def nbytes(self) -> int:
        """Allocated arena bytes (≤ ``budget_bytes`` by construction)."""
        return self._arena.nbytes

    @property
    def used_bytes(self) -> int:
        """Payload bytes currently resident (≤ ``budget_bytes``)."""
        with self._lock:
            return self._used_bytes

    @property
    def resident_count(self) -> int:
        return self.capacity - len(self._free)

    def resident(self, ids: np.ndarray) -> np.ndarray:
        """Boolean mask: which of ``ids`` are currently cached."""
        ids = np.asarray(ids, np.int64)
        with self._lock:
            return self._slot_of[ids] >= 0

    # --------------------------------------------------------------- pins
    def pin(self, ids: np.ndarray):
        """Raise the pin count of ``ids`` (the scheduler's lookahead
        window membership); pinned records are never evicted."""
        with self._lock:
            np.add.at(self._pin, np.asarray(ids, np.int64), 1)

    def unpin(self, ids: np.ndarray):
        with self._lock:
            ids = np.asarray(ids, np.int64)
            np.add.at(self._pin, ids, -1)
            uniq = np.unique(ids)
            counts = self._pin[uniq]
            stray = -int(counts[counts < 0].sum())
            if stray:
                # an unpin with no matching pin is a window-accounting bug
                # (retiring a batch twice, or unpinning a foreign id):
                # clamping silently would let eviction take records another
                # window still relies on — count it so tests can assert 0
                self.stray_unpins += stray
                self._pin[uniq] = np.maximum(counts, 0)

    def pinned(self, ids: np.ndarray) -> np.ndarray:
        with self._lock:
            return self._pin[np.asarray(ids, np.int64)] > 0

    def note_next_use(self, ids: np.ndarray, positions):
        """Record the absolute stream position of each id's next use (the
        Belady eviction priority).  ``positions`` may be scalar
        (broadcast) or per-id; the scheduler calls this as the lookahead
        window retires batches, so priorities are exact under
        clairvoyance rather than estimated."""
        with self._lock:
            self.next_use[np.asarray(ids, np.int64)] = positions

    # ---------------------------------------------------------- accounting
    def account_scratch_copy(self, nbytes: int):
        """The serve path copied ``nbytes`` through an intermediate buffer
        (cache→scratch→destination instead of straight to the ring slot)."""
        with self._lock:
            self.scratch_copies += 1
            self.scratch_copy_bytes += int(nbytes)

    # ---------------------------------------------------------- admission
    def _admission_locked(
        self, nu: Optional[np.ndarray], need: int, free_only: bool = False
    ) -> np.ndarray:
        """Mask over ``need`` insert candidates (non-resident, slot-sized,
        deduplicated): which ones an admission-filtered insert retains.

        Free slots admit unconditionally — caching into an empty slot can
        only add future hits.  Beyond them, admission is an *exchange*
        against the evictable (unpinned) residents: under ``belady`` with
        known ``nu`` (each candidate's next-use stream position), the
        j-th soonest remaining candidate is admitted iff it strictly
        beats the j-th farthest evictable resident — sorted ascending vs
        sorted descending, the greedy pairing is the optimal exchange,
        and the subsequent eviction takes exactly the paired losers.
        Ties (NEVER vs NEVER included) decline: replacing a resident with
        an equally-priced newcomer is pure churn.  Under ``lru`` (or with
        no ``nu``) admission is a capacity check only: first
        ``free + evictable`` candidates, same acceptance order as an
        unfiltered insert, just *decided* instead of ``rejected``.

        ``free_only=True`` disables the exchange: candidates take free
        slots (dead ``NEVER`` residents included under belady) and the
        rest decline — never displacing a live resident.  This is the
        retention-push drain's mode: every pushed record is a placement
        winner, so an exchange would evict one winner for another — pure
        loss — whereas declining lets the requeue retry once the
        receiver's own departures free the slot.
        """
        free = len(self._free)
        occupied = self._id_of[self._id_of >= 0]
        evictable = occupied[self._pin[occupied] == 0]
        take = np.zeros(need, bool)
        room = free + len(evictable)
        if room == 0 or need == 0:
            return take
        if self.policy != "belady" or nu is None:
            take[: min(need, free if free_only else room)] = True
            return take
        # evictable residents with no known future use are as good as
        # free slots: NEVER means "never asked of this tier again" (a
        # consumed record whose predicted next holder is another host, or
        # none), so a candidate may take the slot without the strict
        # sooner-than exchange — in particular a NEVER candidate (a
        # window prefetch with no retention merit) recycles a dead slot
        # instead of being declined by the NEVER-vs-NEVER tie, which
        # would turn the whole prefetch window into demand reads
        dead = int((self.next_use[evictable] == NEVER).sum())
        free += dead
        if free_only:
            room = free
        order = np.argsort(nu, kind="stable")  # soonest next use first
        k = min(need, room)
        cand = order[:k]
        n_beyond = k - free
        if n_beyond > 0:
            live = np.sort(self.next_use[evictable])
            worst = live[live < NEVER][::-1][:n_beyond]
            cand = np.concatenate(
                (cand[:free], cand[free:][nu[cand[free:]] < worst])
            )
        take[cand] = True
        return take

    def admit(
        self, ids: np.ndarray, next_use: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Advisory admission probe (no bytes move): for each of ``ids``,
        would an admission-filtered :meth:`insert` leave it resident?
        Already-resident ids answer True; over-wide records answer False.
        ``next_use`` (aligned with ``ids``) carries each candidate's next
        use — for a prefetch plan that is its *upcoming window use*, for
        a demand insert its position in the next epoch's stream."""
        ids = np.asarray(ids, np.int64)
        with _trace.span("cache/admit", "cache"), self._lock:
            out = self._slot_of[ids] >= 0
            fresh = ~out & (self.record_lengths[ids] <= self.slot_bytes)
            idx = np.flatnonzero(fresh)
            if len(idx) == 0 or self.capacity == 0:
                return out
            uniq, first = np.unique(ids[idx], return_index=True)
            nu = None
            if next_use is not None:
                nu = np.asarray(next_use, np.int64)[idx][first]
            take = self._admission_locked(nu, len(uniq))
            admitted = uniq[take]
            mask = np.zeros(len(self._slot_of), bool)
            mask[admitted] = True
            out[idx] = mask[ids[idx]]
            return out

    # ------------------------------------------------------------- gather
    def gather(
        self, ids: np.ndarray, dst: np.ndarray, dst_off: np.ndarray
    ) -> np.ndarray:
        """Serve cached records into a flat uint8 destination.

        ``dst[dst_off[i] : dst_off[i] + record_lengths[ids[i]]]`` receives
        record ``ids[i]``'s payload for every hit; returns the boolean hit
        mask.  Copies happen under the cache lock, so concurrent
        insert/evict cannot recycle a slot mid-copy.
        """
        ids = np.asarray(ids, np.int64)
        with _trace.span("cache/gather", "cache"), self._lock:
            slots = self._slot_of[ids]
            hit = slots >= 0
            nh = int(hit.sum())
            if nh:
                lens = self.record_lengths[ids[hit]]
                copy_records(
                    self._arena,
                    slots[hit] * self.slot_bytes,
                    dst,
                    np.asarray(dst_off, np.int64)[hit],
                    lens,
                )
                self._tick += 1
                self._last_used[ids[hit]] = self._tick
                self.hit_bytes += int(lens.sum())
            self.hits += nh
            self.misses += len(ids) - nh
            return hit

    # ------------------------------------------------------------- insert
    def insert(
        self,
        ids: np.ndarray,
        src: np.ndarray,
        src_off: np.ndarray,
        next_use: Optional[np.ndarray] = None,
        filtered: bool = False,
        with_bytes: bool = False,
        free_only: bool = False,
    ) -> int:
        """Copy records into the cache from a flat uint8 source (a batch
        arena or dense buffer); returns how many were newly inserted
        (with ``with_bytes=True``, the ``(count, payload_bytes)`` pair —
        the prefetch path's fill accounting needs the exact bytes of the
        *newly inserted* subset, which only this lock can attribute).

        Already-resident ids are skipped (idempotent under the demand /
        prefetch race), records wider than a slot are rejected, and when
        free + evictable slots run out (everything else pinned) the
        overflow is dropped rather than ever exceeding the budget.

        ``filtered=True`` is the planner's admission-filtered insert: the
        same rule :meth:`admit` answers for is applied under this one
        lock, declined records are counted in ``planned_skips`` (never
        ``rejected`` — by construction the admitted set always fits), and
        ``next_use`` (aligned with ``ids``) both drives the belady
        exchange and freshens the admitted records' eviction priorities.
        ``free_only=True`` (with ``filtered``) admits into free capacity
        only — see :meth:`_admission_locked`.
        """
        k, nbytes = self._insert_impl(
            ids, src, src_off, next_use, filtered, free_only
        )
        return (k, nbytes) if with_bytes else k

    def _insert_impl(self, ids, src, src_off, next_use, filtered,
                     free_only=False):
        ids = np.asarray(ids, np.int64)
        src_off = np.asarray(src_off, np.int64)
        if len(ids) == 0 or self.capacity == 0:
            return 0, 0
        if next_use is not None:
            next_use = np.asarray(next_use, np.int64)
        with _trace.span("cache/insert", "cache"), self._lock:
            uniq, first = np.unique(ids, return_index=True)
            keep = self._slot_of[uniq] < 0
            lens = self.record_lengths[uniq]
            keep &= lens <= self.slot_bytes
            uniq, first, lens = uniq[keep], first[keep], lens[keep]
            nu = next_use[first] if next_use is not None else None
            need = len(uniq)
            if need == 0:
                return 0, 0
            if nu is not None:
                # clairvoyant truth for the exchange below and for later
                # evictions; harmless for candidates that end up declined
                self.next_use[uniq] = nu
            if filtered:
                take = self._admission_locked(nu, need, free_only)
                k = int(take.sum())
                if k < need:
                    self.planned_skips += need - k
                    self.planned_skip_bytes += int(lens[~take].sum())
                    uniq, first, lens = uniq[take], first[take], lens[take]
                    need = k
                if need == 0:
                    return 0, 0
            if need > len(self._free):
                self._evict_locked(need - len(self._free))
            k = min(need, len(self._free))
            if k < need:
                self.rejected += need - k
                uniq, first, lens = uniq[:k], first[:k], lens[:k]
            if k == 0:
                return 0, 0
            slots = np.asarray(self._free[-k:], np.int64)
            del self._free[-k:]
            copy_records(
                src, src_off[first], self._arena, slots * self.slot_bytes, lens
            )
            inserted_bytes = int(lens.sum())
            self._slot_of[uniq] = slots
            self._id_of[slots] = uniq
            self._used_bytes += inserted_bytes
            self._tick += 1
            self._last_used[uniq] = self._tick
            self.insertions += k
            return k, inserted_bytes

    def _evict_locked(self, m: int):
        """Drop up to ``m`` unpinned residents: the oldest ticks under
        ``lru``, the farthest (largest) ``next_use`` under ``belady`` —
        one argpartition over the candidate array either way."""
        occupied = np.flatnonzero(self._id_of >= 0)
        cand_ids = self._id_of[occupied]
        unpinned = self._pin[cand_ids] == 0
        occupied, cand_ids = occupied[unpinned], cand_ids[unpinned]
        if len(cand_ids) == 0:
            return
        if len(cand_ids) > m:
            if self.policy == "belady":
                key = -self.next_use[cand_ids]  # farthest next use first
            else:
                key = self._last_used[cand_ids]  # oldest tick first
            pick = np.argpartition(key, m - 1)[:m]
            occupied, cand_ids = occupied[pick], cand_ids[pick]
        self._slot_of[cand_ids] = -1
        self._id_of[occupied] = -1
        self._free.extend(int(s) for s in occupied)
        self._used_bytes -= int(self.record_lengths[cand_ids].sum())
        self.evictions += len(cand_ids)
        if _trace.enabled():
            _trace.instant("cache/evict", "cache",
                           args={"evicted": len(cand_ids)})

    def evict(self, m: int):
        with self._lock:
            self._evict_locked(m)

    def invalidate(self, ids: np.ndarray) -> int:
        """Forcibly drop ``ids`` from the tier (poisoned/partial plans:
        a prefetch that died mid-insert may have left any subset of its
        records resident, possibly with garbage bytes — after this, the
        demand path re-reads them from storage).  Pins are left intact
        (the scheduler's window bookkeeping still retires them); returns
        the number of records actually dropped."""
        ids = np.unique(np.asarray(ids, np.int64))
        with self._lock:
            slots = self._slot_of[ids]
            here = slots >= 0
            if not here.any():
                return 0
            drop_ids, drop_slots = ids[here], slots[here]
            self._slot_of[drop_ids] = -1
            self._id_of[drop_slots] = -1
            self._free.extend(int(s) for s in drop_slots)
            self._used_bytes -= int(self.record_lengths[drop_ids].sum())
            n = len(drop_ids)
            self.invalidations += n
            return n

    # ------------------------------------------------------------- export
    def export_records(self, ids: np.ndarray, release: bool = True):
        """Serve ``ids`` to a *peer host* (the cross-host tier's supply
        side): copy every resident requested id into a fresh arena and —
        with ``release=True`` — free its slot, *move* semantics.  Under
        consumer-caches placement the requester is the record's next
        consumer and becomes its new holder, so keeping a second copy
        here would double-count fleet capacity for a record this host
        will not use again before the requester does.

        Pinned residents are copied but **not** released: a pin means
        this host's own lookahead window still needs the bytes (an epoch
        boundary can put a record in both hosts' windows briefly), and
        dropping it would turn a planned local hit into a storage read.

        Returns ``(found, payload, offsets, lengths)`` where ``found``
        masks ``ids`` (aligned), and ``payload[offsets[i]:offsets[i]+
        lengths[i]]`` is the i-th *found* record.  The copy happens under
        the cache lock (no slot recycling mid-copy); export does not
        touch the hit/miss counters — peer traffic is accounted in
        ``remote_served`` / ``remote_served_bytes``.
        """
        ids = np.asarray(ids, np.int64)
        with _trace.span("cache/export", "cache"), self._lock:
            slots = self._slot_of[ids]
            found = slots >= 0
            fids = ids[found]
            lens = self.record_lengths[fids]
            offsets = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
            payload = np.empty(int(offsets[-1]), np.uint8)
            if len(fids):
                copy_records(
                    self._arena,
                    slots[found] * self.slot_bytes,
                    payload,
                    offsets[:-1],
                    lens,
                )
                self.remote_served += len(fids)
                self.remote_served_bytes += int(lens.sum())
                if release:
                    rel = self._pin[fids] == 0
                    rel_ids = fids[rel]
                    rel_slots = slots[found][rel]
                    if len(rel_ids):
                        self._slot_of[rel_ids] = -1
                        self._id_of[rel_slots] = -1
                        self._free.extend(int(s) for s in rel_slots)
                        self._used_bytes -= int(
                            self.record_lengths[rel_ids].sum()
                        )
                        self.remote_released += len(rel_ids)
            return found, payload, offsets[:-1], lens

    def clear(self):
        with self._lock:
            self._slot_of[:] = -1
            self._id_of[:] = -1
            self._free = list(range(self.capacity))
            self._used_bytes = 0
