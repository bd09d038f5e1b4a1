"""Binary record store with O(1) random record access (the NVM side of LIRS).

Format ("RREC"):
    header (32 B): magic  b"RREC" | version u32 | flags u32 (bit0: variable
    length) | num_records u64 | record_size u64 (0 when variable)
    payload: fixed-size records back-to-back, or, when variable,
    ``u32 length || bytes`` per record (sparse datasets — webspam/kdd style).

The store deliberately does NOT persist an offset index for variable data:
locating records is the job of the paper's *Data-Format-Aware Location
Generator* (repro_torch.core.location), which does one sequential scan — exactly
the pre-processing cost the paper accounts for sparse formats.

All reads go through ``os.pread``/``os.preadv`` (no mmap): each call is an
explicit I/O system call, mirroring the paper's access model, and the store
counts sequential vs random page touches for the storage cost model.

Batch materialization (the hot path) is a coalescing, multi-queue engine:
``plan_extents`` offset-sorts a batch's records and merges neighbours whose
inter-record gap is at most ``gap_bytes`` into single range reads;
``read_batch_into`` scatters the extents into a caller-provided dense
``(B, record_size)`` buffer — ``os.preadv`` directly into NumPy row views,
zero heap ``bytes`` objects — and fans independent extents across a pool of
GIL-releasing reader threads, emulating NVM I/O queue depth > 1 (the regime
where random reads match sequential throughput).  ``IOStats`` is
thread-safe and tracks coalescing efficiency so the paper's cost model can
still price every epoch.

Variable-length (sparse) stores get the same treatment through
``read_batch_ragged``: the coalescing plan is computed entirely in NumPy,
extents land back-to-back in a scratch buffer, and the whole batch
materializes into ONE dense byte *arena* plus ``(offsets, lengths)`` int32
arrays with a single vectorized gather — no per-record ``bytes`` objects,
no per-record Python.  ``RaggedBufferRing`` recycles arena triples for an
allocation-free steady state, mirroring ``BatchBufferRing`` on the dense
side.

I/O accounting happens *after* the extent reads succeed: a batch that dies
on a short ``pread`` and is retried by the caller is charged once, for the
attempt that actually served records (see ``IOStats``).

Fault tolerance (RREC v2, ``repro_torch.storage.faults``): v2 files carry a
per-record checksum table (u32 LE per record, appended after the payload;
header flag bit1, bit2 = CRC32C vs zlib CRC32) that the batch gather paths
verify — ``verify="auto"`` checks only records whose extents needed a
retry or hedge (zero cost on the clean path), ``"full"`` checks
everything.  A mismatch triggers ONE recovery re-read of the record
(transient-fault-free by the injector's taxonomy) before raising a
structured :class:`~repro_torch.storage.faults.CorruptRecordError`.  Transient
pread errors (EINTR/EAGAIN/EIO, and zero-length reads strictly before
EOF) are healed by bounded exponential-backoff retries under a per-batch
deadline; straggler extent chunks can be hedged (read twice, first
finisher wins).  All of it is accounted in ``IOStats`` (``retries``,
``hedged_reads``, ``checksum_failures``, ``degraded_batches``) and made
deterministic/testable by the seed-driven ``FaultInjector`` seam under
every pread.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as _futures_wait
from dataclasses import dataclass, field, fields
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from .faults import (
    CHECKSUM_ALGORITHM,
    DEFAULT_RETRY,
    TRANSIENT_ERRNOS,
    CancelledRead,
    CorruptRecordError,
    FaultInjector,
    RetryPolicy,
    TransientZeroRead,
    checksum32,
)

MAGIC = b"RREC"
VERSION = 2  # current writer version (v2 = per-record checksum table)
V1 = 1       # seed format: no integrity data
HEADER = struct.Struct("<4sIIQQ4x")  # padded to 32 B
HEADER_SIZE = 32
assert HEADER.size == HEADER_SIZE
PAGE = 4096  # OS virtual page size (paper §4.1)

FLAG_VARIABLE = 1
FLAG_CRC = 2      # a u32-LE per-record checksum table follows the payload
FLAG_CRC32C = 4   # table algorithm: CRC32C (Castagnoli); else zlib CRC32


def _is_transient(e: BaseException) -> bool:
    """Transient read faults: retry is allowed to heal these."""
    return (
        isinstance(e, TransientZeroRead)
        or getattr(e, "errno", None) in TRANSIENT_ERRNOS
    )


@dataclass
class IOStats:
    """Thread-safe I/O accounting (multiple reader threads share one store).

    Besides the seed counters it tracks the batch path's *coalescing
    efficiency*: how many records each batch syscall served on average.
    ``records_per_io == 1`` means no merging happened (pure random preads);
    large values mean range reads amortized the syscall + latency cost —
    the host-side analogue of device queue depth.
    """

    random_reads: int = 0        # read syscalls issued at random offsets
    sequential_reads: int = 0    # read syscalls issued sequentially
    bytes_read: int = 0
    pages_read: int = 0          # distinct page frames touched per syscall
    last_offset: int = -1
    batch_records: int = 0       # records served through the batch path
    batch_ios: int = 0           # syscalls the batch path issued for them
    coalesced_ios: int = 0       # batch syscalls that served >= 2 records
    coalesced_records: int = 0   # records served by those merged syscalls
    cache_hits: int = 0          # records served from the DRAM tier instead
    cache_hit_bytes: int = 0     # payload bytes those hits avoided reading
    remote_hits: int = 0         # records served by a peer host's tier
    remote_hit_bytes: int = 0    # payload bytes moved host-to-host instead
    # prefetch-side cache fills, counted at the source so the demand-time
    # ``cache_hits`` they later produce can be decomposed exactly: a
    # record the prefetch worker inserts (from a peer or from storage) is
    # gathered from DRAM at demand time and lands in ``cache_hits`` —
    # subtracting both fill counters leaves the *cross-epoch* local hits,
    # the quantity ``distributed_hit_model``'s "local" tier prices
    peer_refills: int = 0        # peer-served records newly inserted by prefetch
    peer_refill_bytes: int = 0
    prefetch_fills: int = 0      # storage-read records newly inserted by prefetch
    prefetch_fill_bytes: int = 0
    retries: int = 0             # transient-fault re-attempts of an extent
    hedged_reads: int = 0        # duplicate reads issued for straggler chunks
    checksum_failures: int = 0   # records whose payload failed verification
    degraded_batches: int = 0    # batches that needed retry/hedge/re-read
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def account(self, offset: int, length: int):
        with self._lock:
            self._account_locked(offset, length)

    def _account_locked(self, offset: int, length: int):
        first_page = offset // PAGE
        last_page = (offset + max(length, 1) - 1) // PAGE
        pages = last_page - first_page + 1
        if offset == self.last_offset:
            self.sequential_reads += 1
        else:
            self.random_reads += 1
        self.bytes_read += length
        self.pages_read += pages
        self.last_offset = offset + length

    def account_plan(self, extents: Sequence["ReadExtent"]):
        """Account a whole coalesced batch plan at once.

        Classification is derived from the plan (extents in offset order),
        not from execution order, so the numbers are deterministic no
        matter how many worker threads actually issue the reads.
        """
        if not extents:
            return
        self.account_batch(
            np.array([e.offset for e in extents], dtype=np.int64),
            np.array([e.length for e in extents], dtype=np.int64),
            np.array([len(e.rows) for e in extents], dtype=np.int64),
        )

    def account_batch(
        self,
        ext_offsets: np.ndarray,
        ext_lengths: np.ndarray,
        recs_per_ext: np.ndarray,
    ):
        """Vectorized :meth:`account_plan` over extent arrays (same
        semantics, no per-extent Python)."""
        n = len(ext_offsets)
        if n == 0:
            return
        pages = (
            (ext_offsets + np.maximum(ext_lengths, 1) - 1) // PAGE
            - ext_offsets // PAGE
            + 1
        )
        ends = ext_offsets + ext_lengths
        seq = np.empty(n, dtype=bool)
        seq[1:] = ext_offsets[1:] == ends[:-1]
        merged = recs_per_ext >= 2
        with self._lock:
            seq[0] = ext_offsets[0] == self.last_offset
            nseq = int(seq.sum())
            self.sequential_reads += nseq
            self.random_reads += n - nseq
            self.bytes_read += int(ext_lengths.sum())
            self.pages_read += int(pages.sum())
            self.last_offset = int(ends[-1])
            self.batch_records += int(recs_per_ext.sum())
            self.batch_ios += n
            self.coalesced_ios += int(merged.sum())
            self.coalesced_records += int(recs_per_ext[merged].sum())

    def account_cache_hits(self, records: int, nbytes: int):
        """Records a DRAM tier (``repro.prefetch``) served in place of
        storage.  Kept separate from ``batch_records`` so
        ``records_per_io`` keeps meaning *storage* records per *storage*
        I/O when part of a batch never touches the device."""
        with self._lock:
            self.cache_hits += records
            self.cache_hit_bytes += nbytes

    def account_remote_hits(self, records: int, nbytes: int):
        """Records served host-to-host by the cross-host tier
        (``repro.prefetch.distributed``): not a storage read, not a local
        DRAM hit — the middle tier's own column in the summaries."""
        with self._lock:
            self.remote_hits += records
            self.remote_hit_bytes += nbytes

    def account_peer_refills(self, records: int, nbytes: int):
        """Peer-served records the *prefetch* path newly inserted into the
        local tier.  These are already counted in ``remote_hits`` at the
        serve and will surface again as ``cache_hits`` at demand time;
        this counter is what makes the live local split exact
        (``local = cache_hits − peer_refills − prefetch_fills``) instead
        of the old ``total − remote − storage`` derivation."""
        with self._lock:
            self.peer_refills += records
            self.peer_refill_bytes += nbytes

    def account_prefetch_fills(self, records: int, nbytes: int):
        """Storage-read records the prefetch path newly inserted into the
        local tier (the in-window fills whose demand-time gathers are
        ``cache_hits`` but not cross-epoch retention hits)."""
        with self._lock:
            self.prefetch_fills += records
            self.prefetch_fill_bytes += nbytes

    # resilience counters: incremented as the events happen (not batched),
    # so they reconcile against a FaultInjector's log even when a batch
    # ultimately fails and charges no I/O
    def account_retries(self, n: int = 1):
        with self._lock:
            self.retries += n

    def account_hedges(self, n: int = 1):
        with self._lock:
            self.hedged_reads += n

    def account_checksum_failures(self, n: int = 1):
        with self._lock:
            self.checksum_failures += n

    def account_degraded(self, n: int = 1):
        with self._lock:
            self.degraded_batches += n

    @property
    def records_per_io(self) -> float:
        """Coalescing efficiency of the batch path (1.0 = no merging).
        Cache-served records are excluded by construction: only records
        that actually reached storage count in ``batch_records``."""
        return self.batch_records / self.batch_ios if self.batch_ios else 0.0

    def snapshot(self) -> Dict[str, int]:
        """Atomic point-in-time view of every counter.

        Reading fields one by one while producer threads run can observe
        torn multi-field views (``cache_hit_bytes`` already bumped,
        ``cache_hits`` not yet) — any derived ratio then lies.  Taking
        the same lock the writers hold makes the view consistent; this
        is what benchmarks, the metrics registry, and the drift detector
        consume."""
        with self._lock:
            return {
                f.name: getattr(self, f.name)
                for f in fields(self)
                if not f.name.startswith("_")
            }

    @staticmethod
    def delta(new: Dict[str, int], old: Dict[str, int]) -> Dict[str, int]:
        """Counter difference between two :meth:`snapshot` views — the
        steady-state window (e.g. warm epochs only) every model check
        wants.  ``last_offset`` is positional state, not a counter, and
        is carried over from ``new`` unchanged."""
        return {
            k: v - old.get(k, 0) if k != "last_offset" else v
            for k, v in new.items()
        }

    def reset(self):
        with self._lock:
            self.random_reads = self.sequential_reads = 0
            self.bytes_read = self.pages_read = 0
            self.last_offset = -1
            self.batch_records = self.batch_ios = 0
            self.coalesced_ios = self.coalesced_records = 0
            self.cache_hits = self.cache_hit_bytes = 0
            self.remote_hits = self.remote_hit_bytes = 0
            self.peer_refills = self.peer_refill_bytes = 0
            self.prefetch_fills = self.prefetch_fill_bytes = 0
            self.retries = self.hedged_reads = 0
            self.checksum_failures = self.degraded_batches = 0


@dataclass
class ReadExtent:
    """One coalesced range read serving one or more records.

    ``rows[i]`` is the position in the original batch whose record lives at
    ``[rec_offsets[i], rec_offsets[i] + rec_lengths[i])`` inside the extent.
    """

    offset: int               # file offset of the first byte to read
    length: int               # bytes covered by the single range read
    rows: np.ndarray          # destination rows in the batch (int64)
    rec_offsets: np.ndarray   # record payload offsets relative to `offset`
    rec_lengths: np.ndarray


def _sorted_plan(
    offsets: np.ndarray, lengths: np.ndarray, gap_bytes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Shared coalescing core: offset-sort the batch and mark extent cuts.

    Returns ``(order, soff, slen, ends, new_ext)`` where ``order`` sorts
    the batch by offset, ``ends`` is the running furthest byte covered
    (so overlapping/duplicate records extend, never shrink, an extent)
    and ``new_ext[k]`` is True when sorted record ``k`` starts a new
    extent.  Both :func:`plan_extents` and the ragged/dense batch readers
    derive their plans from this single cut rule, so their merge
    semantics are identical by construction.
    """
    key = offsets
    if key.size and key.dtype == np.int64:
        # int32 radix sort is ~2× faster, and offsets fit whenever the
        # store is under 2 GiB (the common dataset regime)
        if 0 <= int(key.min()) and int(key.max()) <= np.iinfo(np.int32).max:
            key = key.astype(np.int32)
    order = np.argsort(key, kind="stable")
    soff = offsets[order]
    slen = lengths[order]
    ends = np.maximum.accumulate(soff + slen)
    n = len(offsets)
    new_ext = np.empty(n, dtype=bool)
    new_ext[0] = True
    # gap between record k+1's start and the furthest byte covered so far
    new_ext[1:] = soff[1:] - ends[:-1] > gap_bytes
    return order, soff, slen, ends, new_ext


def plan_extents(
    offsets: np.ndarray, lengths: np.ndarray, gap_bytes: int
) -> List[ReadExtent]:
    """Offset-sort a batch and merge records whose inter-record gap is at
    most ``gap_bytes`` into single range reads.

    ``gap_bytes=0`` still merges physically adjacent (and duplicate /
    overlapping) records; a negative value disables merging entirely.
    Returns extents in ascending offset order.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(offsets)
    if n == 0:
        return []
    order, soff, slen, ends, new_ext = _sorted_plan(offsets, lengths, gap_bytes)
    cuts = np.flatnonzero(new_ext[1:]) + 1
    extents: List[ReadExtent] = []
    for grp in np.split(np.arange(n), cuts):
        start = int(soff[grp[0]])
        end = int(ends[grp[-1]])
        extents.append(
            ReadExtent(
                offset=start,
                length=end - start,
                rows=order[grp],
                rec_offsets=soff[grp] - start,
                rec_lengths=slen[grp],
            )
        )
    return extents


class RaggedBatch(NamedTuple):
    """A variable-length batch materialized as one dense byte arena.

    ``arena[offsets[i] : offsets[i] + lengths[i]]`` is record ``i``'s
    payload; records are packed back-to-back in batch order, so
    ``offsets`` is the exclusive prefix sum of ``lengths`` and
    ``arena.size == lengths.sum()``.  Offsets are int32 (a single batch
    arena is capped at 2 GiB) — the shape consumed directly by CSR-style
    device packers.
    """

    arena: np.ndarray    # uint8 (total_bytes,)
    offsets: np.ndarray  # int32 (B,) start of record i within the arena
    lengths: np.ndarray  # int32 (B,) payload bytes of record i

    def __len__(self) -> int:
        return len(self.offsets)

    def record(self, i: int) -> np.ndarray:
        """Zero-copy uint8 view of record ``i``."""
        o = int(self.offsets[i])
        return self.arena[o : o + int(self.lengths[i])]

    def tolist(self) -> List[bytes]:
        """Materialize per-record ``bytes`` (test/compat path — the hot
        path never does this)."""
        return [bytes(self.record(i)) for i in range(len(self))]


def alloc_ragged(
    lens: np.ndarray, ring: Optional["RaggedBufferRing"] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Allocate and pack a batch-order arena triple for the given
    per-record payload lengths: ``offsets`` is the exclusive prefix sum
    (the :class:`RaggedBatch` packing rule), the int32 2 GiB arena cap is
    enforced, and slots come from ``ring`` when given (heap fallback
    otherwise).  Shared by :meth:`RecordStore.read_batch_ragged` and the
    tiered read path's ragged serve, so the materialization contract has
    exactly one definition."""
    b = len(lens)
    total = int(lens.sum()) if b else 0
    if total > np.iinfo(np.int32).max:
        raise ValueError(
            f"ragged batch of {total} bytes exceeds the int32 arena "
            "cap (2 GiB); split the batch"
        )
    if ring is not None:
        arena, out_off, out_len = ring.acquire(total, b)
    else:
        arena = np.empty(total, np.uint8)
        out_off = np.empty(b, np.int32)
        out_len = np.empty(b, np.int32)
    if b:
        out_len[:] = lens
        out_off[0] = 0
        if b > 1:
            out_off[1:] = np.cumsum(lens[:-1])
    return arena, out_off, out_len


def _pread_full(
    fd: int,
    buf,
    offset: int,
    injector: Optional[FaultInjector] = None,
    file_size: Optional[int] = None,
    cancel: Optional[threading.Event] = None,
    recovery: bool = False,
):
    """``preadv`` into ``buf`` tolerating short reads.

    A single Linux read is capped at ~2 GiB, and coalescing can legally
    produce extents larger than that (e.g. a whole-dataset sequential
    batch) — so continue from where the kernel stopped.  A zero-length
    read is classified by cause: at or past ``file_size`` it is a genuine
    EOF (the file is shorter than the plan believed — truncation, never
    retryable); strictly before it, a transport hiccup raised as
    :class:`TransientZeroRead` for the retry layer to heal.  When the
    store carries a :class:`FaultInjector`, every pread flows through its
    seam (``recovery=True`` marks checksum-mismatch re-reads, which skip
    transient fault classes).
    """
    view = memoryview(buf).cast("B")
    total = len(view)
    done = 0
    while done < total:
        if injector is not None:
            got = injector.pread(
                fd, view[done:], offset + done, cancel=cancel, recovery=recovery
            )
        else:
            got = os.preadv(fd, [view[done:]], offset + done)
        if got <= 0:
            if file_size is not None and offset + done < file_size:
                raise TransientZeroRead(offset + done, done, total)
            raise IOError(
                f"short read at {offset + done}: EOF after {done}/{total} bytes"
            )
        done += got


class RecordWriter:
    """Sequentially writes a record file (fixed or variable length).

    By default writes RREC v2: each record's payload checksum
    (:func:`~repro_torch.storage.faults.checksum32` over the payload bytes,
    length prefix excluded) is collected and appended after the payload
    as a u32-LE table at :meth:`close`.  ``checksums=False`` reproduces
    the v1 seed format byte-for-byte (no table, version 1).
    """

    def __init__(
        self,
        path: str,
        record_size: Optional[int] = None,
        checksums: bool = True,
    ):
        self.path = path
        self.record_size = record_size
        self.count = 0
        self._f = open(path, "wb")
        self._crcs: Optional[List[int]] = [] if checksums else None
        self._version = VERSION if checksums else V1
        flags = 0 if record_size else FLAG_VARIABLE
        if checksums:
            flags |= FLAG_CRC
            if CHECKSUM_ALGORITHM == "crc32c":
                flags |= FLAG_CRC32C
        self._flags = flags
        self._f.write(
            HEADER.pack(MAGIC, self._version, flags, 0, record_size or 0)
        )

    def append(self, data: bytes):
        if self.record_size is not None:
            if len(data) != self.record_size:
                raise ValueError(
                    f"fixed record size {self.record_size}, got {len(data)}"
                )
            self._f.write(data)
        else:
            self._f.write(struct.pack("<I", len(data)))
            self._f.write(data)
        if self._crcs is not None:
            self._crcs.append(checksum32(data) & 0xFFFFFFFF)
        self.count += 1

    def close(self):
        if self._crcs is not None:
            self._f.write(np.asarray(self._crcs, dtype="<u4").tobytes())
        self._f.seek(0)
        self._f.write(
            HEADER.pack(
                MAGIC, self._version, self._flags, self.count,
                self.record_size or 0,
            )
        )
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordStore:
    """Random-access reader over a record file.

    Resilience knobs:

    ``fault_injector``
        A :class:`~repro_torch.storage.faults.FaultInjector` routed under every
        pread (tests/benchmarks/``--chaos``); ``None`` = direct syscalls.
    ``retry``
        A :class:`~repro_torch.storage.faults.RetryPolicy` (default: bounded
        backoff, 30 s batch deadline, hedging off); ``None`` disables
        retries entirely — any transient fault aborts the batch.
    ``verify``
        Checksum verification of gathered payloads against the RREC v2
        table: ``"auto"`` (default) verifies only records whose extents
        needed a retry or hedge — zero work on the clean path; ``"full"``
        verifies every record on the batch paths (and :meth:`read`);
        ``"off"`` never verifies.  v1 files have no table, so the
        effective mode is ``"off"`` (``"full"`` on a v1 file raises).
    """

    def __init__(
        self,
        path: str,
        *,
        fault_injector: Optional[FaultInjector] = None,
        retry: Optional[RetryPolicy] = DEFAULT_RETRY,
        verify: str = "auto",
    ):
        if verify not in ("off", "auto", "full"):
            raise ValueError(f"verify must be off|auto|full, got {verify!r}")
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        raw = os.pread(self._fd, HEADER_SIZE, 0)
        magic, version, flags, count, rsize = HEADER.unpack(raw)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a RREC file")
        if version > VERSION:
            raise ValueError(
                f"{path}: RREC v{version} is newer than this reader (v{VERSION})"
            )
        self.version = version
        self.variable = bool(flags & FLAG_VARIABLE)
        self.num_records = count
        self.record_size = rsize or None
        self.stats = IOStats()
        self.file_size = os.fstat(self._fd).st_size
        self._injector = fault_injector
        self.retry = retry
        # v2 integrity: the checksum table sits after the payload, so the
        # payload proper ends where the table starts (sequential scans
        # must not parse table bytes as records)
        self.checksums: Optional[np.ndarray] = None
        self.payload_end = self.file_size
        if flags & FLAG_CRC:
            table_bytes = 4 * count
            self.payload_end = self.file_size - table_bytes
            file_algo = "crc32c" if flags & FLAG_CRC32C else "crc32"
            if file_algo == CHECKSUM_ALGORITHM:
                self.checksums = np.frombuffer(
                    os.pread(self._fd, table_bytes, self.payload_end),
                    dtype="<u4",
                )
            elif verify == "full":
                raise ValueError(
                    f"{path}: checksum table is {file_algo} but this host "
                    f"computes {CHECKSUM_ALGORITHM}; cannot verify=full"
                )
        elif verify == "full":
            raise ValueError(
                f"{path}: RREC v{version} has no checksum table; "
                "cannot verify=full"
            )
        self.verify = verify if self.checksums is not None else "off"
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_size = 0
        self._pool_lock = threading.Lock()
        # reusable scratch buffers for the ragged path: a fresh multi-MB
        # np.empty per batch costs a mmap + page faults; steady state
        # should recycle (bounded, concurrent-reader safe)
        self._scratch_pool: List[np.ndarray] = []
        self._scratch_lock = threading.Lock()
        # offsets/lengths are installed by the location generator (sparse)
        # or derived arithmetically (fixed)
        self._offsets: Optional[np.ndarray] = None
        self._lengths: Optional[np.ndarray] = None
        if not self.variable:
            self._offsets = HEADER_SIZE + np.arange(count, dtype=np.int64) * rsize
            self._lengths = np.full(count, rsize, dtype=np.int64)

    # ------------------------------------------------------------- index
    @property
    def indexed(self) -> bool:
        return self._offsets is not None

    def install_index(self, offsets: np.ndarray, lengths: np.ndarray):
        self._offsets = offsets.astype(np.int64)
        self._lengths = lengths.astype(np.int64)

    def offsets(self) -> np.ndarray:
        if self._offsets is None:
            raise RuntimeError(
                "variable-length store has no index; run the location "
                "generator first (repro_torch.core.location)"
            )
        return self._offsets

    def lengths(self) -> np.ndarray:
        self.offsets()
        return self._lengths

    # -------------------------------------------------- fault tolerance
    def _batch_deadline(self) -> Optional[float]:
        pol = self.retry
        if pol is None or pol.deadline_s is None:
            return None
        return time.monotonic() + pol.deadline_s

    def _retry_extent(
        self,
        buf,
        offset: int,
        err: OSError,
        deadline: Optional[float],
        cancel: Optional[threading.Event] = None,
        recovery: bool = False,
    ) -> int:
        """Heal a failed extent read with bounded exponential backoff.

        Entered with the first failure in hand; re-attempts the whole
        extent until it succeeds, the fault turns non-transient, the
        retry budget runs out, or the batch deadline passes — the
        terminal ``IOError`` names the retry count either way.  Returns
        the number of re-attempts used (>= 1).
        """
        pol = self.retry
        r = 0
        while True:
            if pol is None or not _is_transient(err):
                raise err
            if r >= pol.max_retries:
                raise IOError(
                    f"{self.path}: read at offset {offset} failed after "
                    f"{r} retries: {err}"
                ) from err
            if deadline is not None and time.monotonic() >= deadline:
                raise IOError(
                    f"{self.path}: read at offset {offset} exceeded the "
                    f"batch deadline after {r} retries: {err}"
                ) from err
            delay = min(pol.backoff_s * (2.0**r), pol.backoff_cap_s)
            if cancel is not None:
                if cancel.wait(delay):
                    raise CancelledRead()
            elif delay > 0:
                time.sleep(delay)
            r += 1
            self.stats.account_retries(1)
            if _trace.enabled():
                _trace.instant(
                    "storage/retry", "storage",
                    args={"offset": offset, "attempt": r},
                )
            try:
                _pread_full(
                    self._fd, buf, offset, self._injector, self.file_size,
                    cancel, recovery,
                )
                return r
            except CancelledRead:
                raise
            except OSError as e:
                err = e

    def _verify_payload(self, view, rec: int, off: int) -> int:
        """Check one gathered payload against the v2 table; on mismatch
        re-read it once (a recovery read: persistent faults still apply,
        transient ones don't) and raise :class:`CorruptRecordError` if
        the medium is genuinely wrong.  Returns 1 if the first check
        failed (healed or not), 0 otherwise."""
        expected = int(self.checksums[rec])
        if (checksum32(view) & 0xFFFFFFFF) == expected:
            return 0
        self.stats.account_checksum_failures(1)
        if _trace.enabled():
            _trace.instant(
                "storage/checksum_failure", "storage",
                args={"record": rec, "offset": off},
            )
        try:
            _pread_full(
                self._fd, view, off, self._injector, self.file_size,
                None, True,
            )
        except OSError as err:
            self._retry_extent(
                view, off, err, self._batch_deadline(), recovery=True
            )
        actual = checksum32(view) & 0xFFFFFFFF
        if actual != expected:
            raise CorruptRecordError(self.path, rec, off, expected, actual)
        return 1

    def _rows_to_verify(self, b, ext_id, order, retried, hedged):
        """Batch rows needing checksum verification under the current
        mode, or ``None`` when nothing does.  ``"auto"`` flags rows whose
        extent was retried or sat in a hedged chunk (a cancelled loser
        may have written after the winner's bytes were declared good)."""
        if self.verify == "off" or self.checksums is None:
            return None
        if self.verify == "full":
            return range(b)
        flag = retried > 0
        if hedged:
            flag[np.asarray(hedged, dtype=np.int64)] = True
        if not flag.any():
            return None
        return order[flag[ext_id]]

    def _verify_dense(self, idx, out, rows) -> int:
        bad = 0
        offs = self._offsets
        for i in rows:
            i = int(i)
            rec = int(idx[i])
            bad += self._verify_payload(out[i], rec, int(offs[rec]))
        return bad

    def _verify_ragged(self, idx, arena, out_off, out_len, rows) -> int:
        bad = 0
        offs = self._offsets
        skip = 4 if self.variable else 0
        for i in rows:
            i = int(i)
            rec = int(idx[i])
            o = int(out_off[i])
            view = arena[o : o + int(out_len[i])]
            bad += self._verify_payload(view, rec, int(offs[rec]) + skip)
        return bad

    # -------------------------------------------------------------- read
    def read(self, idx: int) -> bytes:
        off = int(self.offsets()[idx])
        ln = int(self._lengths[idx])
        if self.variable:
            off += 4  # skip the u32 length prefix
        self.stats.account(off, ln)
        buf = bytearray(ln)
        try:
            _pread_full(self._fd, buf, off, self._injector, self.file_size)
        except CancelledRead:
            raise
        except OSError as err:
            self._retry_extent(buf, off, err, self._batch_deadline())
        if self.verify == "full":
            self._verify_payload(buf, int(idx), off)
        return bytes(buf)

    def read_batch(self, indices: Sequence[int]) -> List[bytes]:
        """Naive per-record loop (the seed baseline; one syscall + one heap
        allocation per record).  Hot paths use :meth:`read_batch_into` /
        :meth:`read_batch_coalesced`."""
        return [self.read(int(i)) for i in indices]

    # ------------------------------------------- coalesced batch reads
    def plan_batch(
        self, indices: Sequence[int], gap_bytes: int = PAGE
    ) -> List[ReadExtent]:
        """Coalescing plan for a batch: payload offsets, sorted + merged."""
        idx = np.asarray(indices, dtype=np.int64)
        offs = self.offsets()[idx]
        lens = self._lengths[idx]
        if self.variable:
            offs = offs + 4  # skip the u32 length prefix
        return plan_extents(offs, lens, gap_bytes)

    def _acquire_scratch(self, nbytes: int) -> np.ndarray:
        """A reusable uint8 buffer of at least ``nbytes`` (first fit)."""
        with self._scratch_lock:
            for i, buf in enumerate(self._scratch_pool):
                if buf.size >= nbytes:
                    return self._scratch_pool.pop(i)
        return np.empty(nbytes, np.uint8)

    def _release_scratch(self, buf: np.ndarray):
        with self._scratch_lock:
            if len(self._scratch_pool) < 4:
                self._scratch_pool.append(buf)

    def _workers_map(self, fn, extents: List[ReadExtent], workers: int):
        """Run ``fn(chunk, cancel)`` over contiguous extent chunks on the
        pool.  When the retry policy arms hedging (``hedge_s``), a chunk
        that hasn't completed within the threshold is submitted a second
        time and the first finisher wins; the loser is cancelled
        cooperatively (its injected stalls and backoff waits watch the
        ``cancel`` event) and ALWAYS quiesced before this returns, so the
        caller may reuse the destination buffers immediately.  Returns
        the extent ids that were part of a hedged chunk (``"auto"``
        verification re-checks those rows).
        """
        if workers <= 1 or len(extents) <= 1:
            fn(extents, None)
            return []
        workers = min(workers, len(extents))
        step = (len(extents) + workers - 1) // workers
        chunks = [extents[i : i + step] for i in range(0, len(extents), step)]
        pol = self.retry
        hedge_s = pol.hedge_s if pol is not None else None
        # submit under the lock so a concurrent grow can't shut the pool
        # down between our size check and our submits; result-waiting
        # happens outside (workers never take this lock)
        with self._pool_lock:
            if self._pool is None or self._pool_size < workers:
                if self._pool is not None:
                    self._pool.shutdown(wait=True)
                self._pool = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="rrec-io"
                )
                self._pool_size = workers
            cancels = [
                threading.Event() if hedge_s is not None else None
                for _ in chunks
            ]
            futures = [
                self._pool.submit(fn, c, cv) for c, cv in zip(chunks, cancels)
            ]
        if hedge_s is None:
            for f in futures:
                f.result()  # re-raise worker exceptions
            return []
        hedged: List[int] = []
        for i, f in enumerate(futures):
            done, _ = _futures_wait([f], timeout=hedge_s)
            if done:
                f.result()
                continue
            # straggler: duplicate the chunk; first finisher wins
            hcancel = threading.Event()
            with self._pool_lock:
                h = self._pool.submit(fn, list(chunks[i]), hcancel)
            self.stats.account_hedges(1)
            _trace.instant("storage/hedge", "storage")
            hedged.extend(chunks[i])
            _futures_wait({f, h}, return_when=FIRST_COMPLETED)
            first, other = (f, h) if f.done() else (h, f)
            ferr = first.exception()
            if ferr is None or isinstance(ferr, CancelledRead):
                # winner delivered (or was itself cancelled — impossible
                # for the first finisher, kept for safety): stop the loser
                (cancels[i] if first is h else hcancel).set()
            oerr = other.exception()  # quiesce: blocks until it exits
            real = [
                e
                for e in (ferr, oerr)
                if e is not None and not isinstance(e, CancelledRead)
            ]
            if ferr is not None and oerr is not None:
                raise real[0] if real else ferr
        return hedged

    def read_batch_into(
        self,
        indices: Sequence[int],
        out: Optional[np.ndarray] = None,
        *,
        gap_bytes: int = PAGE,
        workers: int = 1,
    ) -> np.ndarray:
        """Coalesced batch read of fixed-size records into a dense buffer.

        Returns a ``(B, record_size)`` uint8 array with ``out[i]`` holding
        record ``indices[i]``.  Single-record extents are ``preadv``'d
        straight into the destination row (zero copy); merged extents are
        range-read into a scratch arena (sized to the coalesced extents
        of this batch, holes included) and scattered with one vectorized
        NumPy pass; extents are fanned across ``workers`` GIL-releasing
        threads to emulate NVM queue depth.  Pass a preallocated ``out``
        (e.g. from a :class:`BatchBufferRing`) to skip the output
        allocation in steady state.
        """
        with _trace.timed(
            "storage/read_batch",
            "storage",
            args={"records": len(indices)} if _trace.enabled() else None,
        ) as sp:
            out = self._read_batch_into(
                indices, out, gap_bytes=gap_bytes, workers=workers
            )
        _metrics.observe("storage/pread_batch_seconds", sp.duration_s)
        return out

    def _read_batch_into(
        self,
        indices: Sequence[int],
        out: Optional[np.ndarray] = None,
        *,
        gap_bytes: int = PAGE,
        workers: int = 1,
    ) -> np.ndarray:
        if self.variable:
            raise ValueError(
                "read_batch_into needs fixed-size records; use "
                "read_batch_coalesced for variable-length stores"
            )
        idx = np.asarray(indices, dtype=np.int64)
        b = len(idx)
        rs = int(self.record_size)
        if out is None:
            out = np.empty((b, rs), dtype=np.uint8)
        else:
            if out.shape != (b, rs) or out.dtype != np.uint8:
                raise ValueError(
                    f"out must be uint8 ({b}, {rs}), got {out.dtype} {out.shape}"
                )
            if not out.flags.c_contiguous:
                raise ValueError("out must be C-contiguous")
        if b == 0:
            return out

        # Plan entirely in record space (everything is rs-aligned): sort
        # the batch, cut where the inter-record byte gap exceeds the
        # threshold, and lay the extents back-to-back in one arena.  The
        # arena is a (total_spanned_records, rs) matrix, so the whole
        # batch materializes with ONE vectorized gather/scatter — no
        # per-record (or per-extent) Python in the plan, only
        # GIL-releasing preadv syscalls in the workers.
        rec = (self._offsets[idx] - HEADER_SIZE) // rs
        order = np.argsort(rec, kind="stable")
        srec = rec[order]
        new_ext = np.empty(b, dtype=bool)
        new_ext[0] = True
        new_ext[1:] = (np.diff(srec) - 1) * rs > gap_bytes
        starts = np.flatnonzero(new_ext)
        ends = np.append(starts[1:], b) - 1
        first = srec[starts]                     # first record id per extent
        span = srec[ends] - first + 1            # records spanned (incl. holes)
        ext_off = HEADER_SIZE + first * rs
        ext_len = span * rs
        ext_recs = np.diff(np.append(starts, b))  # batch records per extent

        # single-record extents preadv straight into their destination row
        # (zero copy); merged extents land back-to-back in a scratch arena
        # sized to coalesced extents only, then scatter in ONE vectorized
        # NumPy pass — no per-record Python anywhere
        single_ext = (span == 1) & (ext_recs == 1)
        arena_span = np.where(single_ext, 0, span)
        bases = np.concatenate(([0], np.cumsum(arena_span)))
        ext_id = np.cumsum(new_ext) - 1
        slots = bases[ext_id] + (srec - first[ext_id])
        pos_multi = ~single_ext[ext_id]          # sorted positions via arena
        arena = np.empty((int(bases[-1]), rs), dtype=np.uint8)
        flat = arena.reshape(-1)
        fd = self._fd
        inj = self._injector
        fsz = self.file_size
        deadline = self._batch_deadline()
        retried = np.zeros(len(starts), np.int32)

        def work(chunk: List[int], cancel=None):
            for e in chunk:
                ln = int(ext_len[e])
                if single_ext[e]:
                    dst = out[order[starts[e]]]
                else:
                    lo = int(bases[e]) * rs
                    dst = flat[lo : lo + ln]
                off = int(ext_off[e])
                try:
                    _pread_full(fd, dst, off, inj, fsz, cancel)
                except CancelledRead:
                    raise
                except OSError as err:
                    retried[e] += self._retry_extent(
                        dst, off, err, deadline, cancel
                    )

        hedged = self._workers_map(work, list(range(len(starts))), workers)
        # account only after every extent read succeeded: a batch that died
        # on a short pread and is retried by the caller must not charge the
        # same extents twice (records_per_io would drift otherwise)
        self.stats.account_batch(ext_off, ext_len, ext_recs)
        if pos_multi.any():
            out[order[pos_multi]] = arena[slots[pos_multi]]
        rows = self._rows_to_verify(b, ext_id, order, retried, hedged)
        bad = self._verify_dense(idx, out, rows) if rows is not None else 0
        if bad or hedged or retried.any():
            self.stats.account_degraded(1)
        return out

    def read_batch_coalesced(
        self,
        indices: Sequence[int],
        *,
        gap_bytes: int = PAGE,
        workers: int = 1,
    ) -> List[bytes]:
        """Coalesced batch read returning ``List[bytes]`` (drop-in for
        :meth:`read_batch`; works for fixed and variable-length stores).

        Rides the ragged engine end-to-end: the plan is the vectorized
        ``_sorted_plan`` cut rule (no per-record Python planning, int32
        radix sort), extents land via the same GIL-releasing workers, and
        ONE arena gather materializes the batch — only the ``List[bytes]``
        contract itself still costs one object per record, at the very
        end.  Identical I/O plan and :class:`IOStats` accounting as
        :meth:`read_batch_ragged` by construction."""
        return self.read_batch_ragged(
            indices, gap_bytes=gap_bytes, workers=workers
        ).tolist()

    def read_batch_ragged(
        self,
        indices: Sequence[int],
        *,
        gap_bytes: int = PAGE,
        workers: int = 1,
        ring: Optional["RaggedBufferRing"] = None,
        out: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    ) -> RaggedBatch:
        """Coalesced batch read of variable-length records into ONE arena.

        The ragged analogue of :meth:`read_batch_into`: the coalescing
        plan is computed entirely in NumPy (same cut rule as
        :func:`plan_extents`, via the shared ``_sorted_plan`` core),
        extents land back-to-back in a scratch buffer via GIL-releasing
        ``preadv`` workers, and the whole batch then materializes with a
        single vectorized gather into a dense uint8 ``arena`` packed in
        batch order, plus ``(offsets, lengths)`` int32 arrays — one
        allocation, zero per-record ``bytes`` objects, zero per-record
        Python.  Works for fixed-size stores too (uniform lengths), but
        its reason to exist is the sparse/SVM path.

        Pass ``ring`` (a :class:`RaggedBufferRing`) to reuse preallocated
        arena triples in steady state; the caller must be done with the
        previous batch before recycling it (the pipeline's ``recycle_fn``
        contract).

        Pass ``out`` — an ``(arena, offsets, lengths)`` triple sized by
        :func:`alloc_ragged` for exactly these indices — to materialize
        into a caller-owned destination instead (the tiered read path's
        zero-copy ring handoff).  The triple's packing is (re)derived from
        the store's lengths, the caller keeps ownership on failure
        (``ring`` must not also be given), and the returned
        :class:`RaggedBatch` wraps the same buffers.
        """
        with _trace.timed(
            "storage/read_ragged",
            "storage",
            args={"records": len(indices)} if _trace.enabled() else None,
        ) as sp:
            batch = self._read_batch_ragged(
                indices, gap_bytes=gap_bytes, workers=workers, ring=ring,
                out=out,
            )
        _metrics.observe("storage/pread_batch_seconds", sp.duration_s)
        return batch

    def _read_batch_ragged(
        self,
        indices: Sequence[int],
        *,
        gap_bytes: int = PAGE,
        workers: int = 1,
        ring: Optional["RaggedBufferRing"] = None,
        out: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    ) -> RaggedBatch:
        idx = np.asarray(indices, dtype=np.int64)
        b = len(idx)
        if b:
            offs = self.offsets()[idx]
            lens = self._lengths[idx]
            if self.variable:
                offs = offs + 4  # skip the u32 length prefix
        else:
            offs = np.empty(0, np.int64)
            lens = np.empty(0, np.int64)
        if out is not None:
            if ring is not None:
                raise ValueError("pass either ring= or out=, not both")
            arena, out_off, out_len = out
            total = int(lens.sum())
            if arena.size != total or len(out_off) != b or len(out_len) != b:
                raise ValueError(
                    f"out triple sized ({arena.size}, {len(out_off)}, "
                    f"{len(out_len)}), batch needs ({total}, {b}, {b})"
                )
            if arena.dtype != np.uint8 or not arena.flags.c_contiguous:
                raise ValueError(
                    f"out arena must be C-contiguous uint8, got "
                    f"{arena.dtype}"
                )
            if b:
                # re-derive the packing rule so a stale/foreign triple
                # cannot silently scatter records to wrong offsets
                out_len[:] = lens
                out_off[0] = 0
                if b > 1:
                    out_off[1:] = np.cumsum(lens[:-1])
        else:
            arena, out_off, out_len = alloc_ragged(lens, ring)
        if b == 0:
            return RaggedBatch(arena, out_off, out_len)
        try:
            return self._fill_ragged(
                idx, arena, out_off, out_len, offs, lens, int(lens.sum()),
                gap_bytes, workers,
            )
        except BaseException:
            # hand the slot back on failure (e.g. a short pread the caller
            # will retry) — otherwise every error drains the ring and
            # silently disables the allocation-free steady state
            if ring is not None:
                ring.recycle(arena)
            raise

    def _fill_ragged(
        self, idx, arena, out_off, out_len, offs, lens, total, gap_bytes,
        workers,
    ) -> RaggedBatch:
        # arena/out_off/out_len arrive packed by :func:`alloc_ragged`
        b = len(lens)
        order, soff, slen, ends, new_ext = _sorted_plan(offs, lens, gap_bytes)
        ext_id = np.cumsum(new_ext) - 1
        starts = np.flatnonzero(new_ext)
        last = np.append(starts[1:], b) - 1
        ext_off = soff[starts]
        ext_len = ends[last] - ext_off
        ext_recs = np.diff(np.append(starts, b))
        bases = np.concatenate(([0], np.cumsum(ext_len)))
        # padded to a word boundary so the uint32 fast-path view is legal
        scratch_bytes = int(bases[-1])
        scratch_buf = self._acquire_scratch(-(-scratch_bytes // 4) * 4)
        try:
            scratch = scratch_buf[: -(-scratch_bytes // 4) * 4]
            fd = self._fd
            inj = self._injector
            fsz = self.file_size
            deadline = self._batch_deadline()
            retried = np.zeros(len(starts), np.int32)

            def work(chunk: List[int], cancel=None):
                for e in chunk:
                    lo = int(bases[e])
                    dst = scratch[lo : lo + int(ext_len[e])]
                    off = int(ext_off[e])
                    try:
                        _pread_full(fd, dst, off, inj, fsz, cancel)
                    except CancelledRead:
                        raise
                    except OSError as err:
                        retried[e] += self._retry_extent(
                            dst, off, err, deadline, cancel
                        )

            hedged = self._workers_map(work, list(range(len(starts))), workers)
            # post-execution accounting: see read_batch_into
            self.stats.account_batch(ext_off, ext_len, ext_recs)

            # ONE vectorized gather scatters every record into the arena.
            # Because the arena is packed (dest offsets are the running
            # total), byte k of the output pulls from scratch position
            # ``(src_row − out_off)[record(k)] + k`` — a repeat, an iota
            # and a take.  Index math runs in int32 whenever scratch fits
            # (4 GiB of index traffic per batch otherwise), and when every
            # record is 4-byte aligned — true for the sparse SVM encoding,
            # whose records are all ``8 + 8·nnz`` bytes — the gather moves
            # uint32 *words*, 4× fewer elements than a byte gather.
            src_row = np.empty(b, np.int64)
            src_row[order] = bases[ext_id] + (soff - ext_off[ext_id])
            delta = src_row - out_off  # int64; per-record (src − dst)
            small = scratch_bytes <= np.iinfo(np.int32).max
            aligned = (
                small
                and not (delta & 3).any()
                and not (out_len & 3).any()
            )
            if aligned:
                words = out_len.astype(np.int32) >> 2
                flat = np.repeat((delta >> 2).astype(np.int32), words)
                flat += np.arange(total >> 2, dtype=np.int32)
                np.take(
                    scratch.view(np.uint32), flat, out=arena.view(np.uint32)
                )
            else:
                it = np.int32 if small else np.int64
                flat = np.repeat(delta.astype(it), out_len)
                flat += np.arange(total, dtype=it)
                np.take(scratch, flat, out=arena)
            rows = self._rows_to_verify(b, ext_id, order, retried, hedged)
            bad = (
                self._verify_ragged(idx, arena, out_off, out_len, rows)
                if rows is not None
                else 0
            )
            if bad or hedged or retried.any():
                self.stats.account_degraded(1)
            return RaggedBatch(arena, out_off, out_len)
        finally:
            self._release_scratch(scratch_buf)

    def read_range(self, start: int, count: int) -> List[bytes]:
        """Sequential read of [start, start+count) records (BMF/TFIP path)."""
        off0 = int(self.offsets()[start])
        end_idx = start + count - 1
        off1 = int(self._offsets[end_idx]) + int(self._lengths[end_idx])
        if self.variable:
            off1 += 4
        blob = os.pread(self._fd, off1 - off0, off0)
        self.stats.account(off0, off1 - off0)
        out = []
        for i in range(start, start + count):
            o = int(self._offsets[i]) - off0
            ln = int(self._lengths[i])
            if self.variable:
                o += 4
            out.append(blob[o : o + ln])
        return out

    def scan_sequential(self, chunk_bytes: int = 1 << 20):
        """Yield (offset, raw_chunk) sequentially over the payload.

        Bounded by ``payload_end``, not the file size: a v2 store's
        checksum table must never be parsed as record bytes (the location
        generator walks this scan to index variable-length data)."""
        pos = HEADER_SIZE
        while pos < self.payload_end:
            n = min(chunk_bytes, self.payload_end - pos)
            self.stats.account(pos, n)
            yield pos, os.pread(self._fd, n, pos)
            pos += n

    # -------------------------------------------------- page-group helpers
    def page_of(self, idx) -> np.ndarray:
        """Page id containing the start of each record."""
        return (self.offsets()[idx] // PAGE).astype(np.int64)

    def page_groups(self) -> List[np.ndarray]:
        """Consecutive record index ranges grouped by starting page —
        the unit of the paper's page-aware shuffling."""
        pages = self.offsets() // PAGE
        # records are laid out sequentially: group boundaries where page changes
        cuts = np.flatnonzero(np.diff(pages)) + 1
        return np.split(np.arange(self.num_records, dtype=np.int64), cuts)

    def close(self):
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
        os.close(self._fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BatchBufferRing:
    """Preallocated ring of ``(batch, record_size)`` destination buffers.

    Reusing destination buffers removes the per-batch allocation from the
    producer loop.  Contract: the consumer must be done with a batch before
    recycling it (``InputPipeline(recycle_fn=ring.recycle)`` enforces this
    by recycling only after the consumer asks for the *next* batch).  If
    every ring buffer is in flight, ``acquire`` falls back to a fresh heap
    allocation (counted in ``misses``) rather than blocking.
    """

    def __init__(self, batch_size: int, record_size: int, depth: int = 4):
        self.batch_size = batch_size
        self.record_size = record_size
        # strong references to the owned buffers: ownership is checked by
        # identity against live objects, never by id() (ids get reused
        # once a dropped buffer is collected)
        self._owned: List[np.ndarray] = [
            np.empty((batch_size, record_size), np.uint8) for _ in range(depth)
        ]
        self._free: List[np.ndarray] = list(self._owned)
        self._lock = threading.Lock()
        self.misses = 0

    def acquire(self, batch_size: Optional[int] = None) -> np.ndarray:
        """A ``(batch_size, record_size)`` buffer (a view for short final
        batches)."""
        b = self.batch_size if batch_size is None else batch_size
        if b > self.batch_size:
            raise ValueError(f"batch {b} exceeds ring batch {self.batch_size}")
        with self._lock:
            if self._free:
                buf = self._free.pop()
            else:
                self.misses += 1
                buf = np.empty((self.batch_size, self.record_size), np.uint8)
        return buf[:b] if b != self.batch_size else buf

    def recycle(self, arr):
        """Return a buffer (or any view chain over one — slices, dtype
        reinterprets) to the ring; foreign arrays are ignored, so it is
        safe as a blanket ``recycle_fn``."""
        buf = arr
        while getattr(buf, "base", None) is not None:
            buf = buf.base
        with self._lock:
            if any(b is buf for b in self._owned) and not any(
                b is buf for b in self._free
            ):
                self._free.append(buf)


class RaggedBufferRing:
    """Preallocated ring of ragged arena triples (arena, offsets, lengths).

    The variable-length sibling of :class:`BatchBufferRing`: each slot
    owns a ``capacity_bytes`` uint8 arena plus ``batch_size`` int32
    offset/length arrays; ``acquire(total, b)`` hands out views sliced to
    the batch at hand.  Slot identity is tracked by the arena object, so
    :meth:`recycle` accepts a :class:`RaggedBatch`, a bare arena (or any
    view chain over one) and ignores foreign arrays — safe as a blanket
    ``recycle_fn`` on an :class:`~repro_torch.core.pipeline.InputPipeline`.
    Batches too large for a slot fall back to fresh heap allocations
    (counted in ``misses``) rather than blocking or failing.
    """

    def __init__(self, capacity_bytes: int, batch_size: int, depth: int = 4):
        self.capacity_bytes = capacity_bytes
        self.batch_size = batch_size
        self._owned: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = [
            (
                np.empty(capacity_bytes, np.uint8),
                np.empty(batch_size, np.int32),
                np.empty(batch_size, np.int32),
            )
            for _ in range(depth)
        ]
        self._free: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = list(
            self._owned
        )
        self._lock = threading.Lock()
        self.misses = 0

    def acquire(
        self, total_bytes: int, batch: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Views ``(arena[:total_bytes], offsets[:batch], lengths[:batch])``
        over a free slot, or fresh arrays when none fits."""
        slot = None
        with self._lock:
            if (
                total_bytes <= self.capacity_bytes
                and batch <= self.batch_size
                and self._free
            ):
                slot = self._free.pop()
            else:
                self.misses += 1
        if slot is None:
            return (
                np.empty(total_bytes, np.uint8),
                np.empty(batch, np.int32),
                np.empty(batch, np.int32),
            )
        arena, off, ln = slot
        return arena[:total_bytes], off[:batch], ln[:batch]

    def recycle(self, item):
        """Return a slot to the ring; accepts the :class:`RaggedBatch` (or
        its arena / any view over it) handed out by ``acquire``."""
        arena = item.arena if isinstance(item, RaggedBatch) else item
        if isinstance(arena, tuple):  # a bare (arena, off, len) triple
            arena = arena[0]
        buf = arena
        while getattr(buf, "base", None) is not None:
            buf = buf.base
        with self._lock:
            for slot in self._owned:
                if slot[0] is buf:
                    if not any(s[0] is buf for s in self._free):
                        self._free.append(slot)
                    return


def write_records(
    path: str,
    records: Iterable[bytes],
    record_size: Optional[int] = None,
    checksums: bool = True,
) -> int:
    with RecordWriter(path, record_size, checksums=checksums) as w:
        for r in records:
            w.append(r)
        return w.count
