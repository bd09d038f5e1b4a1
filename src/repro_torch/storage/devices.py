"""Storage device performance models (paper Table 2).

IOPS are 4 KiB-operation rates; the time to service an access pattern is
    T = pages / IOPS(pattern type)
which is exactly the granularity the paper reasons at.  These models let a
CPU-only box reproduce Figs 10/11/13 as a faithful cost model, and they
drive the I/O simulator used by the training-time benchmarks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

PAGE = 4096

EVICTION_POLICIES = ("lru", "belady")


def lru_hit_fraction(c: float, window_frac: float = 0.0) -> float:
    """Steady-state hit rate of an LRU record cache holding a capacity
    fraction ``c`` of the dataset, under LIRS's per-epoch uniform
    permutation (every record reused exactly once per epoch).

    A record last used at epoch position ``q`` and reused at position
    ``p`` of the next epoch sees ``(n−q) + p·q/n`` distinct records in
    between; it survives LRU iff that is under capacity.  Integrating
    over uniform ``q, p``:

        hit(c) = c + (1 − c)·ln(1 − c)          (→ 1 as c → 1)

    — far below ``c`` for small budgets: full-range shuffling is the
    classic LRU scanning pathology, recency carries no signal.

    ``window_frac`` = λ models a clairvoyant prefetcher running λ·n
    records ahead of demand (the pinned lookahead window).  Pins cost no
    capacity — the window is the most recently touched set, the top of
    the LRU stack, retained by recency anyway — but admission *shortens*
    every reuse interval by λ·n (a record is readmitted, and counts as a
    hit, λ·n accesses before its use), so the survival condition becomes
    ``(1−x) + max(0, y−λ)·x < c``.  Integrating:

        hit(c, λ) = (λ+1)·(x* − x₀) − x₀·ln(x*/x₀) + max(0, 1 − x*)

    with ``x₀ = 1 − c`` and ``x* = min(1, x₀/λ)``; λ = 0 recovers the
    classic form, and for small λ the correction is ``≈ λ·c``.
    """
    c = min(1.0, max(0.0, c))
    if c >= 1.0:
        return 1.0
    if c <= 0.0:
        return 0.0
    lam = max(0.0, window_frac)
    if lam == 0.0:
        return c + (1.0 - c) * math.log1p(-c)
    x0 = 1.0 - c
    xs = min(1.0, x0 / lam)
    h = (lam + 1.0) * (xs - x0) - x0 * (math.log(xs) - math.log(x0))
    return min(1.0, h + max(0.0, 1.0 - xs))


def belady_hit_fraction(c: float, window_frac: float = 0.0) -> float:
    """Steady-state hit rate of a Belady (farthest-next-use) record cache
    of capacity fraction ``c`` under the same permutation stream:

        hit(c) = c                              (exactly)

    Every reuse interval spans exactly one epoch boundary (a record's
    next use is always in the *next* epoch), so at most ``capacity``
    retained intervals can straddle any boundary — no policy can serve
    more than ``capacity`` hits per epoch.  Belady attains the bound:
    a resident not yet used this epoch has an earlier next use than any
    already-used (waiting) record, so farthest-next-use eviction only
    ever takes waiting records and every epoch-start resident survives
    to its use.  Exactly ``capacity`` hits per epoch, from the second
    epoch on — linear in budget where LRU collapses quadratically.

    ``window_frac`` is accepted for signature parity and ignored: the
    pinned lookahead window is a *subset* of what farthest-next-use
    retains anyway (the soonest next uses are, by definition, the records
    about to be demanded), so the prefetch working set costs Belady no
    retention capacity at all.
    """
    del window_frac
    return min(1.0, max(0.0, c))


def wasted_read_fraction(
    c: float,
    policy: str = "belady",
    batch_frac: float = 0.0,
    planner: bool = True,
    window_frac: float = 0.0,
) -> float:
    """Fraction of an epoch's records the tier reads from storage *beyond*
    the policy's steady-state miss floor ``(1 − hit(c)) · n`` — the price
    of admission decided by arrival order instead of by reuse.

    With the policy-aware planner on, waste is identically **0**: every
    plan is occupancy-simulated before the read, every insert is
    admission-filtered (a record only displaces a resident with a
    *farther* reuse), and every skipped record is a single expected
    demand miss — so per-epoch storage reads are exactly the misses.
    Under ``belady`` the hit floor itself is exact (``hit = c``), making
    the planner-on read count ``(1 − c)·n`` exactly; under ``lru`` the
    same holds around that policy's own closed form.

    Planner-off, the unfiltered insert admits incoming records in
    arrival order and lets eviction clean up afterwards.  While the
    cache is wider than a batch (``c ≥ batch_frac``) the pinned-window
    machinery absorbs this and waste stays ~0; *below* it (the regime
    where ``TieredCache.rejected`` blows up: a single batch overwhelms
    free + evictable slots) arrival-order admission churns the retained
    set wholesale — each batch's overflow evicts or rejects exactly the
    soon-reuse residents the policy meant to keep, the cross-epoch
    retention benefit collapses to ~0, and the epoch reads ~``n``
    records instead of ``(1 − hit(c))·n``.  The forfeited fraction *is*
    the modeled hit rate:

        wasted(c) = hit(c)        for c < batch_frac, planner off
                  = 0             otherwise

    Validated against the record-granularity ``LRUPageCache`` /
    ``BeladyPageCache`` simulators (admission-exact by construction:
    their reads equal their misses, the planner-on floor) and against
    the live tier's per-epoch storage reads in
    ``benchmarks/prefetch.py --policy-sweep`` (wasted-bytes column).
    """
    if planner:
        return 0.0
    if batch_frac > 0.0 and c < batch_frac:
        return cache_hit_model(c, policy, window_frac)
    return 0.0


def block_lru_hit_fraction(
    c: float,
    block_frac: float = 0.0,
    span_frac: float = 0.0,
    window_frac: float = 0.0,
    grid: int = 2048,
) -> float:
    """LRU hit rate under a *block-quantized* once-per-epoch stream
    (CorgiPile / Corgi²: shuffled block order, full shuffle only inside a
    ``span_frac``·n-record buffer; ``block_frac``·n records share a block
    and therefore share a buffer group in **every** epoch).

    The classic derivation (:func:`lru_hit_fraction`) prices the distinct
    records between a use at epoch position ``x`` and the reuse at ``y``
    as ``D = (1−x) + x·y`` — every other record lands in the tail/head
    segments independently.  Block streams break that independence for
    the records *near* the one being priced:

    * a **same-block** peer shares the buffer group in both epochs, so it
      joins the overlap with probability 1/4 (before/after within the
      group is a fair coin each epoch) instead of ``(1−x)·y``;
    * a **same-group** peer (same buffer, different block) shares the
      group in one epoch only: tail membership there is a fair coin while
      the other epoch stays uniform — ``y/2`` and ``(1−x)/2`` for the
      epoch-``e`` and epoch-``e+1`` groups respectively.

    Subtracting those corrections from the overlap leaves, with
    ``s_b = block_frac`` and ``s = span_frac``,

        D(x, y) = A(x) + B(x)·y
        A(x) = (1−x)·(1 − (s−s_b)/2) − s_b/4
        B(x) = (3s − s_b)/2 + (1 − 2s + s_b)·x

    and ``hit = Pr[D < c]`` over uniform ``x, y`` — a one-dimensional
    integral since ``D`` is linear in ``y``, evaluated by midpoint rule.
    ``s = s_b = 0`` recovers the classic closed form exactly; the
    expansion is first-order in the span (valid for ``span_frac ≲ 0.5``
    — a buffer that big is already "almost full shuffle").
    ``window_frac`` = λ is the prefetch-window correction, entering the
    same way as in :func:`lru_hit_fraction` (admission runs λ·n ahead,
    so ``y`` becomes ``max(0, y − λ)``).  Validated against
    ``LRUPageCache`` replays of real block streams in
    ``tests/test_shuffle_quality.py``.
    """
    c = min(1.0, max(0.0, c))
    if c >= 1.0:
        return 1.0
    if c <= 0.0:
        return 0.0
    s_b = min(max(0.0, block_frac), 0.5)
    s = min(max(s_b, span_frac), 0.5)
    if s == 0.0:
        return lru_hit_fraction(c, window_frac)
    lam = max(0.0, window_frac)
    acc = 0.0
    for i in range(grid):
        x = (i + 0.5) / grid
        a = (1.0 - x) * (1.0 - (s - s_b) / 2.0) - s_b / 4.0
        b = (3.0 * s - s_b) / 2.0 + (1.0 - 2.0 * s + s_b) * x
        if a >= c:
            continue
        if b <= 0.0:
            acc += 1.0
            continue
        acc += min(1.0, lam + (c - a) / b)
    return min(1.0, acc / grid)


def block_cache_hit_model(
    c: float,
    policy: str = "lru",
    block_frac: float = 0.0,
    span_frac: float = 0.0,
    window_frac: float = 0.0,
) -> float:
    """Closed-form DRAM-tier hit rate under a block-shuffle stream
    (CorgiPile / Corgi²) — the strategy-aware sibling of
    :func:`cache_hit_model`.

    Belady is **unchanged**: the pigeonhole argument behind
    :func:`belady_hit_fraction` only needs every record to be consumed
    exactly once per epoch (each reuse interval straddles exactly one
    epoch boundary), which any block shuffle preserves — ``hit = c``
    exactly, for every block and buffer size.  LRU picks up the
    block-local correlation correction (:func:`block_lru_hit_fraction`).
    ``block_frac = span_frac = 0`` reduces to :func:`cache_hit_model`.
    """
    if policy == "belady":
        return belady_hit_fraction(c, window_frac)
    if policy == "lru":
        return block_lru_hit_fraction(c, block_frac, span_frac, window_frac)
    raise ValueError(
        f"eviction policy must be one of {EVICTION_POLICIES}, got {policy!r}"
    )


def cache_hit_model(
    c: float, policy: str = "lru", window_frac: float = 0.0
) -> float:
    """Closed-form DRAM-tier hit rate at capacity fraction ``c`` for the
    given eviction ``policy`` (``repro.prefetch``'s ``TieredCache``) with
    a prefetch lookahead window of ``window_frac`` of the dataset pinned,
    validated against the record-granularity ``LRUPageCache`` /
    ``BeladyPageCache`` simulators in ``repro.storage.page_cache`` and
    against the live tier in ``benchmarks/prefetch.py``."""
    if policy == "lru":
        return lru_hit_fraction(c, window_frac)
    if policy == "belady":
        return belady_hit_fraction(c, window_frac)
    raise ValueError(
        f"eviction policy must be one of {EVICTION_POLICIES}, got {policy!r}"
    )


def distributed_hit_model(
    c_global: float,
    hosts: int,
    policy: str = "belady",
    window_frac: float = 0.0,
) -> dict:
    """Closed-form tier split for the multi-host clairvoyant tier.

    ``c_global`` is the *fleet* capacity fraction (``sum(capacity_h)/n``)
    spread over ``hosts`` consumer-caches hosts (the
    ``repro.sharding.placement`` rule: each record is retained, if at
    all, by its last consumer).  Two observations give the split:

    * **total hit is capacity-shaped, not host-shaped.**  Aggregate
      retained slots are ``c_global·n`` whether they sit in one cache or
      ``H``; under Belady the distributed pigeonhole (every resident's
      next use is exactly one epoch away, farthest-next-use never evicts
      a not-yet-used resident on any host) makes aggregate hits exactly
      ``c_global·n`` per steady epoch.  Under LRU, host ``h`` sees
      ``1/H`` of the insert stream with ``1/H`` of the capacity — reuse
      distances and capacity scale together, so the classic closed form
      survives unchanged:  ``hit = cache_hit_model(c_global, policy)``.
    * **the holder is uniform over hosts.**  Epoch permutations are
      independent, so a retained record's *next* consumer is any host
      with probability ``1/H``: a fraction ``1/H`` of hits are local
      (DRAM), ``(H−1)/H`` are remote (peer-served, priced by
      :class:`NetworkModel`).

    Returns ``{"local", "remote", "storage"}`` fractions of the epoch's
    record accesses (summing to 1), validated against
    :class:`repro.storage.page_cache.DistributedCacheSim`.
    """
    if hosts < 1:
        raise ValueError("hosts must be >= 1")
    hit = cache_hit_model(c_global, policy, window_frac)
    return {
        "local": hit / hosts,
        "remote": hit * (hosts - 1) / hosts,
        "storage": 1.0 - hit,
    }


def zipf_popularity(n: int, alpha: float = 1.0):
    """IRM popularity law for a served request stream: ``p_i ∝ 1/i^alpha``
    over ``n`` items (1-indexed ranks), normalized.  Returns a list of
    floats, most popular first."""
    if n < 1:
        raise ValueError("n must be >= 1")
    w = [1.0 / (i ** alpha) for i in range(1, n + 1)]
    s = sum(w)
    return [x / s for x in w]


def che_characteristic_time(popularity, capacity: int) -> float:
    """Che's characteristic time ``T`` for an LRU cache of ``capacity``
    slots under IRM popularity: the root of
    ``sum_i (1 - exp(-p_i T)) = capacity`` (each item occupies the cache
    iff re-requested within ``T``; the expected occupancy must equal the
    capacity).  Solved by bisection — the left side is monotone in ``T``."""
    n = len(popularity)
    if capacity <= 0:
        return 0.0
    if capacity >= n:
        return math.inf
    lo, hi = 0.0, 1.0

    def occupancy(t: float) -> float:
        return sum(1.0 - math.exp(-p * t) for p in popularity)

    while occupancy(hi) < capacity:
        hi *= 2.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if occupancy(mid) < capacity:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def served_hit_model(
    popularity, capacity: int, policy: str = "lru"
) -> float:
    """Closed-form hit rate of the *served* (request-stream) feature
    cache — the IRM sibling of :func:`cache_hit_model`, which prices the
    tier under a training permutation.

    A request stream has no clairvoyant schedule: items recur under a
    popularity law (IRM — :func:`zipf_popularity` for the synthetic
    workloads) instead of exactly once per epoch, so the permutation
    closed forms do not apply.  Two anchors bracket any reasonable
    policy:

    * ``lru`` — Che's approximation: ``hit = sum_i p_i (1 − exp(−p_i T))``
      with ``T`` from :func:`che_characteristic_time`.
    * ``belady`` (= clairvoyant / perfect-LFU) — the cache holds exactly
      the ``capacity`` most popular items: ``hit = sum of the top-C
      popularity mass``.  This is the ceiling the estimated-reuse
      admission (``repro.serve.reuse``) approaches as its interarrival
      estimates converge on true popularity.

    ``benchmarks/serve_latency.py`` and ``tests/test_serve.py`` hold the
    measured estimated-reuse hit rate to the [LRU, clairvoyant] band.
    """
    n = len(popularity)
    if capacity >= n:
        return 1.0
    if capacity <= 0:
        return 0.0
    if policy == "lru":
        t = che_characteristic_time(popularity, capacity)
        return sum(p * (1.0 - math.exp(-p * t)) for p in popularity)
    if policy == "belady":
        return sum(sorted(popularity, reverse=True)[:capacity])
    raise ValueError(
        f"eviction policy must be one of {EVICTION_POLICIES}, got {policy!r}"
    )


@dataclass(frozen=True)
class NetworkModel:
    """Host-to-host link pricing for the cross-host tier.

    A remote record read costs one RTT (request + response headers) plus
    payload at link bandwidth, overlapped across ``max_inflight``
    outstanding peer fetches — the same queue-depth shape as
    :class:`StorageModel.t_rand_read`.  Defaults model a 25 GbE
    data-center link; the point of the tier is that even 10 GbE beats a
    random NVM read storm, and *always* beats HDD."""

    name: str = "25GbE"
    bandwidth_Bps: float = 25e9 / 8
    rtt_s: float = 20e-6
    max_inflight: float = 32.0

    def t_remote_read(
        self, n_fetches: float, nbytes: float = 0.0, inflight: float = 1.0
    ) -> float:
        if n_fetches <= 0:
            return 0.0
        q = max(1.0, min(inflight, self.max_inflight))
        return n_fetches * self.rtt_s / q + nbytes / self.bandwidth_Bps

    def t_epoch_remote(self, plan, hosts: int) -> float:
        """Remote-tier time for one epoch of an ``IOPlan`` across
        ``hosts``.  ``plan.cache_hit_fraction`` is the *total* tier hit
        rate; a ``(hosts−1)/hosts`` share of those hits is peer-served
        (holder uniform over hosts — see :func:`distributed_hit_model`)
        and moves host-to-host instead of from storage."""
        if hosts <= 1:
            return 0.0
        hit = min(1.0, max(0.0, float(getattr(plan, "cache_hit_fraction", 0.0))))
        frac = hit * (hosts - 1) / hosts
        n = plan.epoch_rand_read_ios * frac
        b = plan.epoch_rand_read_bytes * frac
        return self.t_remote_read(n, b, inflight=getattr(plan, "queue_depth", 1.0))


DEFAULT_NETWORK = NetworkModel()


@dataclass(frozen=True)
class StorageModel:
    name: str
    seq_read_iops: float
    seq_write_iops: float
    rand_read_iops: float
    rand_write_iops: float
    # I/O queue depth beyond which more in-flight requests stop helping.
    # Table 2 rates are single-stream; NVM parallelism scales them until
    # the device's internal channels saturate.  HDDs seek serially.
    max_queue_depth: float = 1.0
    # Tail latency: a ``straggler_frac`` of random reads stall for
    # ``tail_latency_s`` beyond the IOPS-rate service time (GC pauses,
    # die collisions, link retrains).  Zero by default so Table 2
    # reproductions are unchanged; set both to price resilience.
    tail_latency_s: float = 0.0
    straggler_frac: float = 0.0

    # ------------------------------------------------------------- times
    def t_seq_read(self, nbytes: float) -> float:
        return self._pages(nbytes) / self.seq_read_iops

    def t_seq_write(self, nbytes: float) -> float:
        return self._pages(nbytes) / self.seq_write_iops

    def t_rand_read(
        self, n_ios: float, nbytes: float = 0.0, queue_depth: float = 1.0
    ) -> float:
        """n_ios random operations moving nbytes total.  Each random op
        pays the random-IOPS cost; volume beyond one page per op streams
        at sequential speed.  ``queue_depth`` > 1 overlaps the per-op
        latency across in-flight requests, up to ``max_queue_depth``."""
        pages = self._pages(nbytes)
        extra = max(0.0, pages - n_ios)
        qd = max(1.0, min(queue_depth, self.max_queue_depth))
        return n_ios / (self.rand_read_iops * qd) + extra / self.seq_read_iops

    def t_rand_write(
        self, n_ios: float, nbytes: float = 0.0, queue_depth: float = 1.0
    ) -> float:
        pages = self._pages(nbytes)
        extra = max(0.0, pages - n_ios)
        qd = max(1.0, min(queue_depth, self.max_queue_depth))
        return n_ios / (self.rand_write_iops * qd) + extra / self.seq_write_iops

    def t_tail(
        self,
        n_ios: float,
        straggler_frac: float = None,
        hedge_timeout_s: float = None,
    ) -> float:
        """Expected tail-latency cost of ``n_ios`` random reads.

        Each straggler pays the device's ``tail_latency_s`` stall.  With
        hedged reads armed (``hedge_timeout_s``), the wait is capped at
        the hedge threshold plus one duplicate I/O at the random rate —
        Dean & Barroso's tail-at-scale bound — whenever that is cheaper
        than riding out the stall."""
        f = self.straggler_frac if straggler_frac is None else straggler_frac
        if n_ios <= 0 or f <= 0.0 or self.tail_latency_s <= 0.0:
            return 0.0
        stall = self.tail_latency_s
        if hedge_timeout_s is not None:
            hedged = hedge_timeout_s + 1.0 / self.rand_read_iops
            stall = min(stall, hedged)
        return n_ios * f * stall

    # --------------------------------------------------- IOPlan pricing
    def t_epoch_read(self, plan) -> float:
        """Per-epoch read time for an ``IOPlan`` (duck-typed to avoid a
        storage→core import cycle).

        Sequential volume streams at sequential speed; the random part is
        priced at the plan's *issued* I/O count (already divided by the
        coalescing factor for batch engines — dense or ragged) with the
        plan's queue depth overlapping per-op latency up to
        ``max_queue_depth``.

        A partially cache-served epoch (``plan.cache_hit_fraction`` > 0,
        set when a DRAM tier sits above the device — the clairvoyant
        prefetch subsystem) only sends the *miss* fraction to storage:
        issued random I/Os and random bytes both scale by
        ``1 − cache_hit_fraction``; sequential volume (BMF/TFIP block
        scans) is not tiered and stays full price."""
        t = 0.0
        if plan.epoch_seq_read_bytes:
            t += self.t_seq_read(plan.epoch_seq_read_bytes)
        miss = 1.0 - min(
            1.0, max(0.0, float(getattr(plan, "cache_hit_fraction", 0.0)))
        )
        if plan.epoch_rand_read_ios and miss > 0.0:
            t += self.t_rand_read(
                plan.epoch_rand_read_ios * miss,
                plan.epoch_rand_read_bytes * miss,
                queue_depth=getattr(plan, "queue_depth", 1.0),
            )
            t += self.t_tail(
                plan.epoch_rand_read_ios * miss,
                getattr(plan, "straggler_frac", None),
                getattr(plan, "hedge_timeout_s", None),
            )
        return t

    def t_preprocess(self, plan) -> float:
        """One-time pre-processing cost of an ``IOPlan`` (BMF/TFIP shuffle
        write-back, or the sparse offset-table scan for LIRS)."""
        t = 0.0
        if plan.preprocess_seq_read_bytes:
            t += self.t_seq_read(plan.preprocess_seq_read_bytes)
        if plan.preprocess_rand_write_ios:
            t += self.t_rand_write(
                plan.preprocess_rand_write_ios, plan.preprocess_rand_write_bytes
            )
        return t

    def t_total(self, plan, epochs: int) -> float:
        """Paper Eq. 1's storage term: preprocess + epochs · per-epoch."""
        return self.t_preprocess(plan) + epochs * self.t_epoch_read(plan)

    @staticmethod
    def _pages(nbytes: float) -> float:
        return max(1.0, nbytes / PAGE) if nbytes > 0 else 0.0


# Table 2 of the paper
HDD = StorageModel("HDD-WD10EZEX", 40_000, 36_000, 600, 300, max_queue_depth=1.0)
SSD = StorageModel(
    "SSD-Intel-750", 563_000, 230_000, 430_000, 230_000, max_queue_depth=8.0
)
OPTANE = StorageModel(
    "OptaneSSD-P4800X", 614_000, 512_000, 550_000, 500_000, max_queue_depth=16.0
)

STORAGE_MODELS = {"hdd": HDD, "ssd": SSD, "optane": OPTANE}
