"""Batch-composition strategies (the heart of the paper's comparison).

All shufflers yield, per epoch, a sequence of batches of instance indices
and expose an ``io_plan()`` describing the storage access pattern the
strategy induces, so the device cost models (Table 2) can price an epoch
without real hardware.

LIRSShuffler   full-range re-shuffle every epoch; batches are read with
               *random* I/O.  Page-aware mode groups instances sharing a
               page into the same batch (paper §4.1).
BMFShuffler    Block Minimization Framework: one-time physical shuffle into
               fixed blocks (pre-processing: sequential read + random
               write-back), then per-epoch re-shuffle of *block order only*;
               blocks are read sequentially.
TFIPShuffler   TensorFlow input pipeline: sequential reads through a
               bounded shuffle queue of Q instances; randomness limited to
               the queue window.  queue_size=1 ≡ no shuffling.

Block-shuffle spectrum (CorgiPile / Corgi², see PAPERS.md) — partial
shuffles between TFIP's window and LIRS's full permutation:

CorgiPileShuffler     shuffle *block order* per epoch, read each block
                      (near-)sequentially, and shuffle record order inside
                      a bounded buffer of ``buffer_blocks`` blocks.  Blocks
                      are contiguous runs of the physical layout, so the
                      per-epoch I/O is block-sequential; DRAM is bounded by
                      the buffer.  block_records=1, buffer_blocks=1 ≡ a
                      full per-epoch permutation (the LIRS extreme).
CorgiSquaredShuffler  Corgi²'s hybrid: a one-time offline block *scatter*
                      (each block is a random subset, physically rewritten
                      contiguous — priced exactly like BMF's
                      pre-processing), then CorgiPile-style online
                      shuffling over the scattered blocks.  Per-epoch cost
                      equals CorgiPile's; within-batch randomness
                      approaches LIRS's because block contents are spread
                      uniformly over the id space.

Both expose the same ``epoch_index_stream(epoch)`` / ``epoch_batches`` /
``io_plan()`` contract as LIRS: their streams are fully deterministic
given (seed, epoch), so the clairvoyant machinery — LookaheadScheduler,
the admission planner, Belady eviction, multi-host placement — works
unchanged on top of them.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.assignment import FeistelAssignment, TableAssignment
from repro_torch.storage.devices import block_cache_hit_model, cache_hit_model


@dataclasses.dataclass
class IOPlan:
    """Per-epoch storage access pattern (for the device cost models).

    ``epoch_rand_read_ios`` already reflects coalescing: it counts *issued*
    range reads, not records.  ``coalescing_factor`` (records per random
    I/O) and ``queue_depth`` (concurrent reader threads) record how the
    batch engine was configured so the device models can price the epoch
    at the right effective IOPS.  ``mean_record_bytes`` carries the
    dataset's mean instance size — for ragged (variable-length) stores
    it is what converts the byte-denominated merge gap into record units,
    so the same geometric coalescing model prices non-uniform extents.
    ``StorageModel.t_epoch_read`` / ``t_preprocess`` consume a plan
    directly.

    ``cache_hit_fraction`` models a DRAM tier above the device (the
    clairvoyant prefetch subsystem, ``repro.prefetch``): the fraction of
    an epoch's records served from memory instead of storage, under the
    tier's ``eviction_policy`` (``lru`` or ``belady`` — see
    ``repro_torch.storage.devices.cache_hit_model`` for the two closed forms).
    The random-read fields stay *cache-less* epoch totals — the device
    model scales both the issued I/Os and the bytes by
    ``1 − cache_hit_fraction`` when pricing, so one plan prices any
    budget by overriding the field.
    """

    preprocess_seq_read_bytes: float = 0.0
    preprocess_rand_write_ios: float = 0.0
    preprocess_rand_write_bytes: float = 0.0
    epoch_seq_read_bytes: float = 0.0
    epoch_rand_read_ios: float = 0.0
    epoch_rand_read_bytes: float = 0.0
    coalescing_factor: float = 1.0
    queue_depth: float = 1.0
    mean_record_bytes: float = 0.0
    cache_hit_fraction: float = 0.0
    eviction_policy: str = "lru"
    # resilience pricing (StorageModel.t_tail): fraction of this plan's
    # random reads expected to stall at the device's tail latency, and
    # the hedged-read threshold if the reader arms hedging (None = no
    # hedging; the full stall is paid)
    straggler_frac: Optional[float] = None
    hedge_timeout_s: Optional[float] = None


def expected_coalescing_factor(
    num_items: int, batch_size: int, gap_records: float
) -> float:
    """Expected records per coalesced I/O for a uniform random batch.

    Sorting a batch of B uniform draws from N records makes neighbour
    spacing ~geometric with p = B/N; two sorted neighbours merge when
    their spacing is at most ``1 + gap_records``, which happens with
    probability 1 − (1−p)^(1+g).  Hence

        E[#extents] ≈ 1 + (B−1)·(1−p)^(1+g),
        factor      = B / E[#extents]  ≥ 1.
    """
    b = min(batch_size, num_items)
    if b <= 1 or num_items <= 1:
        return 1.0
    p = b / num_items
    survive = (1.0 - p) ** (1.0 + max(0.0, gap_records))
    extents = 1.0 + (b - 1) * survive
    return b / extents


def expected_ragged_coalescing_factor(
    num_items: int, batch_size: int, gap_bytes: float, mean_record_bytes: float
) -> float:
    """Expected records per coalesced I/O over a *variable-length* store.

    Two sorted batch neighbours spaced ``s`` records apart are separated
    by the ``s − 1`` records between them, whose total size concentrates
    around ``(s − 1)·μ`` for mean record size μ.  Pricing the byte gap at
    its mean reduces the ragged case to the dense formula with
    ``gap_records = gap_bytes / μ`` — a mean-field approximation that is
    first-order exact (length fluctuations only perturb merges whose gap
    lands within one record-size deviation of the threshold, a
    vanishing fraction as B grows; the ragged_read benchmark checks the
    model against measured ``records_per_io``).
    """
    if mean_record_bytes <= 0:
        return 1.0
    return expected_coalescing_factor(
        num_items, batch_size, gap_bytes / mean_record_bytes
    )


class LIRSShuffler:
    def __init__(
        self,
        num_items: int,
        batch_size: int,
        seed: int = 0,
        page_aware: bool = False,
        page_groups: Optional[Sequence[np.ndarray]] = None,
        assignment: str = "table",
        avg_instance_bytes: float = 0.0,
    ):
        self.num_items = num_items
        self.batch_size = batch_size
        self.page_aware = page_aware
        self.page_groups = list(page_groups) if page_groups is not None else None
        if page_aware and self.page_groups is None:
            raise ValueError("page_aware LIRS needs page_groups from the record store")
        n_units = len(self.page_groups) if page_aware else num_items
        cls = TableAssignment if assignment == "table" else FeistelAssignment
        self.assignment = cls(n_units, seed)
        self.avg_instance_bytes = avg_instance_bytes

    @property
    def table_nbytes(self) -> int:
        return self.assignment.nbytes

    def epoch_batches(self, epoch: int) -> Iterator[np.ndarray]:
        if not self.page_aware:
            perm = self.assignment.epoch_permutation(epoch)
            for i in range(0, self.num_items - self.batch_size + 1, self.batch_size):
                yield perm[i : i + self.batch_size]
            rem = self.num_items % self.batch_size
            if rem:
                yield perm[self.num_items - rem :]
            return
        # page-aware: permute page groups; fill batches with whole pages
        order = self.assignment.epoch_permutation(epoch)
        batch: List[np.ndarray] = []
        n = 0
        for gi in order:
            grp = self.page_groups[int(gi)]
            batch.append(grp)
            n += len(grp)
            if n >= self.batch_size:
                yield np.concatenate(batch)
                batch, n = [], 0
        if batch:
            yield np.concatenate(batch)

    def epoch_index_stream(self, epoch: int) -> np.ndarray:
        """The epoch's full record access sequence, known up front.

        Equals ``np.concatenate(list(epoch_batches(epoch)))`` — the
        clairvoyance the prefetch subsystem exploits: because LIRS
        permutes *indexes*, the entire storage order of an epoch (and of
        every future epoch) exists before the first read is issued.
        """
        if not self.page_aware:
            return self.assignment.epoch_permutation(epoch)
        order = self.assignment.epoch_permutation(epoch)
        return np.concatenate([self.page_groups[int(g)] for g in order])

    def io_plan(
        self,
        total_bytes: float,
        is_sparse: bool,
        coalesce_gap: float = 0.0,
        queue_depth: float = 1.0,
        cache_budget_bytes: float = 0.0,
        prefetch_window_bytes: float = 0.0,
        eviction_policy: str = "lru",
    ) -> IOPlan:
        """Price an epoch.  ``coalesce_gap`` (bytes) and ``queue_depth``
        describe the batch-materialization engine: gap-merging shrinks the
        number of issued random I/Os by the expected coalescing factor,
        and queue depth is forwarded for the device models' concurrency
        scaling (``StorageModel.t_rand_read``).

        ``cache_budget_bytes`` models the DRAM tier (``repro.prefetch``):
        a record cache of capacity fraction ``c = budget / total`` under
        LIRS's per-epoch uniform permutation, with the hit rate given by
        the ``eviction_policy``'s closed form
        (:func:`repro_torch.storage.devices.cache_hit_model`):

            lru:     hit(c, λ) = c + (1 − c)·ln(1 − c) + ≈λ·c
            belady:  hit(c, λ) = c                       (exactly)

        LRU sits far below ``c`` for small budgets (the classic scanning
        pathology: full-range shuffling is adversarial for recency) while
        Belady — the farthest-next-use rule the clairvoyant tier can run
        because every future position is known — meets the per-epoch
        upper bound of one hit per slot.  Both forms are validated
        against the record-granularity ``LRUPageCache`` /
        ``BeladyPageCache`` simulators.  ``prefetch_window_bytes`` is the
        prefetcher's in-flight working set (pinned lookahead records),
        entering as the window fraction ``λ = window / total``: pins cost
        no capacity under either policy (the window is the top of the
        LRU stack, and a subset of what Belady retains by definition),
        but admission runs λ·n records ahead of demand, which shortens
        every LRU reuse interval — the λ-correction in
        :func:`repro_torch.storage.devices.lru_hit_fraction`.  The *miss*
        sub-batch is what the batch engine coalesces, so the coalescing
        factor is evaluated at the effective batch size
        ``batch · (1 − hit)``; the device model then scales issued I/Os
        and bytes by the miss fraction.
        """
        plan = IOPlan()
        plan.mean_record_bytes = self.avg_instance_bytes
        plan.eviction_policy = eviction_policy
        if is_sparse:  # offset-table scan (Fig 7b)
            plan.preprocess_seq_read_bytes = total_bytes
        hit = 0.0
        if cache_budget_bytes > 0 and total_bytes > 0:
            c = min(1.0, cache_budget_bytes / total_bytes)
            lam = (
                min(prefetch_window_bytes, cache_budget_bytes, total_bytes)
                / total_bytes
            )
            hit = cache_hit_model(c, eviction_policy, window_frac=lam)
        plan.cache_hit_fraction = hit
        if self.page_aware:
            n_ios = len(self.page_groups)
        else:
            n_ios = self.num_items
        if coalesce_gap > 0 and self.avg_instance_bytes > 0 and not self.page_aware:
            # same geometric model for fixed and ragged stores: the byte
            # gap is priced in units of the mean record size
            plan.coalescing_factor = expected_ragged_coalescing_factor(
                self.num_items,
                max(1.0, self.batch_size * (1.0 - hit)),
                coalesce_gap,
                self.avg_instance_bytes,
            )
            n_ios = n_ios / plan.coalescing_factor
        plan.queue_depth = max(1.0, queue_depth)
        plan.epoch_rand_read_ios = n_ios
        plan.epoch_rand_read_bytes = total_bytes
        return plan


class BMFShuffler:
    def __init__(self, num_items: int, num_blocks: int, seed: int = 0):
        self.num_items = num_items
        self.num_blocks = num_blocks
        rng = np.random.default_rng((seed, 0xB3F))
        # the one-time physical shuffle: a fixed random partition into blocks
        perm = rng.permutation(num_items).astype(np.int64)
        self.blocks = np.array_split(perm, num_blocks)
        self.seed = seed

    def epoch_batches(self, epoch: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng((self.seed, epoch + 1))
        for bi in rng.permutation(self.num_blocks):
            # block contents are physically contiguous after pre-processing:
            # reading one is a sequential scan
            yield self.blocks[int(bi)]

    def epoch_index_stream(self, epoch: int) -> np.ndarray:
        """Full epoch access sequence (= concatenated block batches)."""
        return np.concatenate(list(self.epoch_batches(epoch)))

    def io_plan(self, total_bytes: float, is_sparse: bool) -> IOPlan:
        return IOPlan(
            # pre-processing: read everything once + write it back in
            # randomly assigned order (Fig 7a)
            preprocess_seq_read_bytes=total_bytes,
            preprocess_rand_write_ios=self.num_items,
            preprocess_rand_write_bytes=total_bytes,
            epoch_seq_read_bytes=total_bytes,
        )


class TFIPShuffler:
    def __init__(self, num_items: int, batch_size: int, queue_size: int, seed: int = 0):
        self.num_items = num_items
        self.batch_size = batch_size
        self.queue_size = max(1, queue_size)
        self.seed = seed

    def epoch_order(self, epoch: int) -> np.ndarray:
        """Streaming window shuffle of sequential reads."""
        rng = np.random.default_rng((self.seed, epoch))
        q: List[int] = []
        out = np.empty(self.num_items, dtype=np.int64)
        w = 0
        for i in range(self.num_items):
            q.append(i)
            if len(q) >= self.queue_size:
                j = rng.integers(len(q))
                q[j], q[-1] = q[-1], q[j]
                out[w] = q.pop()
                w += 1
        while q:
            j = rng.integers(len(q))
            q[j], q[-1] = q[-1], q[j]
            out[w] = q.pop()
            w += 1
        return out

    def epoch_batches(self, epoch: int) -> Iterator[np.ndarray]:
        order = self.epoch_order(epoch)
        for i in range(0, self.num_items, self.batch_size):
            yield order[i : i + self.batch_size]

    def epoch_index_stream(self, epoch: int) -> np.ndarray:
        """Full epoch access sequence (the streaming-window shuffle order)."""
        return self.epoch_order(epoch)

    def queue_nbytes(self, instance_bytes: float) -> float:
        """Host memory the shuffle queue occupies (paper §3.2: 7.3 GB)."""
        return self.queue_size * instance_bytes

    def io_plan(self, total_bytes: float, is_sparse: bool) -> IOPlan:
        return IOPlan(
            # TFIP also fully shuffles the dataset once before training
            preprocess_seq_read_bytes=total_bytes,
            preprocess_rand_write_ios=self.num_items,
            preprocess_rand_write_bytes=total_bytes,
            epoch_seq_read_bytes=total_bytes,
        )


class CorgiPileShuffler:
    """Block + buffer shuffle (CorgiPile): per-epoch shuffled *block
    order*, records shuffled only inside a sliding buffer of
    ``buffer_blocks`` blocks.

    Blocks are contiguous runs of the physical record layout
    (``array_split`` of ``arange``), so an epoch reads the file as
    ``num_blocks`` near-sequential segments in random order — the I/O is
    block-sequential while DRAM stays bounded by the buffer.  The stream
    for every epoch is a deterministic function of ``(seed, epoch)``,
    which is all the clairvoyant tier needs: ``LookaheadScheduler``,
    the admission planner, Belady eviction and multi-host placement
    consume ``epoch_index_stream`` exactly as they do for LIRS.

    Extremes: ``block_records = buffer_blocks = 1`` degenerates to a full
    per-epoch permutation (every record is its own block, block order is
    the permutation — the LIRS limit); one block spanning the dataset
    with ``buffer_blocks = 1`` also yields a full shuffle (the buffer is
    the dataset).  In between, randomness is quantized to the buffer
    span ``buffer_blocks · block_records``.
    """

    def __init__(
        self,
        num_items: int,
        batch_size: int,
        block_records: int,
        buffer_blocks: int = 2,
        seed: int = 0,
        avg_instance_bytes: float = 0.0,
    ):
        if num_items <= 0:
            raise ValueError("num_items must be positive")
        self.num_items = num_items
        self.batch_size = batch_size
        self.block_records = max(1, min(int(block_records), num_items))
        self.buffer_blocks = max(1, int(buffer_blocks))
        self.num_blocks = -(-num_items // self.block_records)
        self.seed = seed
        self.avg_instance_bytes = avg_instance_bytes
        self.blocks = self._make_blocks()
        self._stream_cache: dict = {}

    def _make_blocks(self) -> List[np.ndarray]:
        # contiguous physical runs: reading one is (near-)sequential
        return np.array_split(
            np.arange(self.num_items, dtype=np.int64), self.num_blocks
        )

    def _epoch_rng_key(self, epoch: int):
        return (self.seed, 0xC09, epoch)

    @property
    def span_records(self) -> float:
        """Mean records resident in the shuffle buffer (the randomness
        window): ``buffer_blocks`` blocks of mean size n / num_blocks."""
        return min(
            float(self.num_items),
            self.buffer_blocks * self.num_items / self.num_blocks,
        )

    def epoch_index_stream(self, epoch: int) -> np.ndarray:
        """Full epoch access sequence, known up front.

        Shuffled block order, then a full shuffle *within* each group of
        ``buffer_blocks`` consecutive blocks — the bounded-buffer
        semantics of CorgiPile's tuple-level shuffle, made deterministic
        per (seed, epoch) so prefetch clairvoyance survives.
        """
        cached = self._stream_cache.get(epoch)
        if cached is not None:
            return cached
        rng = np.random.default_rng(self._epoch_rng_key(epoch))
        order = rng.permutation(self.num_blocks)
        out = np.empty(self.num_items, dtype=np.int64)
        w = 0
        for g in range(0, self.num_blocks, self.buffer_blocks):
            buf = np.concatenate(
                [self.blocks[int(b)] for b in order[g : g + self.buffer_blocks]]
            )
            rng.shuffle(buf)
            out[w : w + len(buf)] = buf
            w += len(buf)
        if len(self._stream_cache) >= 4:
            self._stream_cache.pop(next(iter(self._stream_cache)))
        self._stream_cache[epoch] = out
        return out

    def epoch_batches(self, epoch: int) -> Iterator[np.ndarray]:
        stream = self.epoch_index_stream(epoch)
        for i in range(0, self.num_items - self.batch_size + 1, self.batch_size):
            yield stream[i : i + self.batch_size]
        rem = self.num_items % self.batch_size
        if rem:
            yield stream[self.num_items - rem :]

    def io_plan(
        self,
        total_bytes: float,
        is_sparse: bool,
        coalesce_gap: float = 0.0,
        queue_depth: float = 1.0,
        cache_budget_bytes: float = 0.0,
        prefetch_window_bytes: float = 0.0,
        eviction_policy: str = "lru",
    ) -> IOPlan:
        """Price an epoch of the block stream.

        Two strategy-specific corrections over the LIRS plan:

        * **Coalescing is span-local.**  A batch of ``B`` records is
          drawn from the current buffer span ``S`` (not from all ``n``),
          so sorted-batch neighbour spacing is geometric with density
          ``B/S`` — dense enough that the batch engine's gap-merge folds
          each batch into a handful of near-sequential extent reads.
          The plan prices that by evaluating
          :func:`expected_coalescing_factor` with the *span* as the
          population; ``span → n`` recovers the LIRS pricing, a 1-record
          span prices one seek per record.
        * **The DRAM-tier hit rate uses the block-corrected form.**
          Same-block records co-travel every epoch and same-buffer
          records co-travel within one, which breaks the uniform-
          permutation assumption behind ``lru_hit_fraction`` —
          :func:`repro_torch.storage.devices.block_cache_hit_model` carries
          the first-order correction (Belady stays ``hit = c`` exactly:
          the pigeonhole argument only needs once-per-epoch streams).
        """
        plan = IOPlan()
        plan.mean_record_bytes = self.avg_instance_bytes
        plan.eviction_policy = eviction_policy
        if is_sparse:  # offset-table scan (Fig 7b)
            plan.preprocess_seq_read_bytes = total_bytes
        hit = 0.0
        if cache_budget_bytes > 0 and total_bytes > 0:
            c = min(1.0, cache_budget_bytes / total_bytes)
            lam = (
                min(prefetch_window_bytes, cache_budget_bytes, total_bytes)
                / total_bytes
            )
            hit = block_cache_hit_model(
                c,
                eviction_policy,
                block_frac=self.block_records / self.num_items,
                span_frac=self.span_records / self.num_items,
                window_frac=lam,
            )
        plan.cache_hit_fraction = hit
        n_ios = float(self.num_items)
        if self.avg_instance_bytes > 0:
            gap_records = max(0.0, coalesce_gap) / self.avg_instance_bytes
            span = max(1, int(round(self.span_records)))
            b_eff = max(1.0, self.batch_size * (1.0 - hit))
            plan.coalescing_factor = expected_coalescing_factor(
                span, int(min(b_eff, span)), gap_records
            )
            n_ios = n_ios / plan.coalescing_factor
        plan.queue_depth = max(1.0, queue_depth)
        plan.epoch_rand_read_ios = n_ios
        plan.epoch_rand_read_bytes = total_bytes
        return plan


class CorgiSquaredShuffler(CorgiPileShuffler):
    """Corgi²'s hybrid offline–online shuffle.

    Offline, once: partition records into blocks *at random* (each block
    a uniform subset, not a contiguous run) and physically rewrite the
    file so each block's members land contiguous — the same full
    read + random write-back pass BMF prices as pre-processing.  Online,
    per epoch: CorgiPile over the scattered blocks (shuffled block order,
    buffer-bounded record shuffle).

    The per-epoch I/O shape and cost equal CorgiPile's (blocks are
    contiguous *after* the rewrite), but because block membership is
    uniform over the id space, a batch is statistically close to a
    uniform sample — within-batch randomness approaches LIRS's at
    block-sequential read cost.  What remains limited is *cross-epoch*
    decorrelation: same-block records travel together in every epoch,
    which is exactly the ``block_frac`` term of the block-corrected
    cache model.

    ``physical_order()`` gives the rewritten layout (block concatenation)
    so a harness measuring real I/O can materialize the scattered store;
    ``epoch_index_stream`` stays in *logical* record ids.
    """

    def __init__(
        self,
        num_items: int,
        batch_size: int,
        block_records: int,
        buffer_blocks: int = 2,
        seed: int = 0,
        avg_instance_bytes: float = 0.0,
    ):
        super().__init__(
            num_items,
            batch_size,
            block_records,
            buffer_blocks,
            seed,
            avg_instance_bytes,
        )

    def _make_blocks(self) -> List[np.ndarray]:
        # the one-time offline scatter: a fixed random partition, then a
        # physical rewrite makes each block contiguous (priced in io_plan)
        rng = np.random.default_rng((self.seed, 0xC52))
        scatter = rng.permutation(self.num_items).astype(np.int64)
        return np.array_split(scatter, self.num_blocks)

    def _epoch_rng_key(self, epoch: int):
        return (self.seed, 0xC52, epoch + 1)

    def physical_order(self) -> np.ndarray:
        """Record ids in rewritten-file order (offline scatter output)."""
        return np.concatenate(self.blocks)

    def io_plan(
        self,
        total_bytes: float,
        is_sparse: bool,
        coalesce_gap: float = 0.0,
        queue_depth: float = 1.0,
        cache_budget_bytes: float = 0.0,
        prefetch_window_bytes: float = 0.0,
        eviction_policy: str = "lru",
    ) -> IOPlan:
        plan = super().io_plan(
            total_bytes,
            is_sparse,
            coalesce_gap,
            queue_depth,
            cache_budget_bytes,
            prefetch_window_bytes,
            eviction_policy,
        )
        # offline scatter pass, priced like BMF's pre-processing (Fig 7a):
        # read everything once sequentially, write it back in scattered
        # block order with random I/O.  Dominates is_sparse's offset scan.
        plan.preprocess_seq_read_bytes = total_bytes
        plan.preprocess_rand_write_ios = float(self.num_items)
        plan.preprocess_rand_write_bytes = total_bytes
        return plan
