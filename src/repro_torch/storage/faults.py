"""Deterministic fault injection + resilience policy for the NVM read path.

LIRS hammers storage with huge volumes of random preads, and real devices
answer with more than clean data: transient ``EINTR``/``EAGAIN``/``EIO``,
zero-length and short reads, multi-millisecond tail stalls, and — rarely
but fatally for training reproducibility — silent bit rot.  This module
gives the read stack one seam for all of it:

* :class:`FaultSpec` / :class:`FaultInjector` — a seed-driven, fully
  deterministic fault schedule injected *under* the record store's pread
  layer.  Every decision is a pure hash of ``(seed, offset, attempt)``,
  so a chaos run replays bit-for-bit from its seed no matter how many
  reader threads interleave, and the injector's counters can be
  reconciled exactly against the store's ``IOStats``.

  Fault taxonomy (mirrors the failure modes of real NVM parts):

  ====================  =============================================
  transient (per attempt — a retry sees a fresh roll)
  --------------------  ---------------------------------------------
  ``transient_rate``    raise ``OSError`` (EINTR / EAGAIN / EIO)
  ``zero_read_rate``    return 0 bytes mid-file (link hiccup)
  ``short_read_rate``   return fewer bytes than asked
  ``bitflip_rate``      flip one bit of the returned payload
  ``stall_rate``        sleep ``stall_s`` before serving (straggler)
  ====================  =============================================
  persistent (a property of the medium, applied on *every* read,
  including recovery re-reads)
  --------------------  ---------------------------------------------
  ``eio_extents``       byte ranges that always raise EIO (dead block)
  ``corrupt_offsets``   file bytes that always read back bit-flipped
  ====================  =============================================

  *Recovery* reads (the store's checksum-mismatch re-read path) skip the
  transient classes — they model a second, independent transfer — but
  still see the persistent ones: media corruption does not go away by
  asking again, which is exactly what lets the store distinguish a
  flipped transfer (retry heals it) from rotted bytes
  (:class:`CorruptRecordError`).

* :class:`RetryPolicy` — bounded exponential backoff for transient
  errors, a per-batch deadline, and an optional hedged-read threshold
  (``hedge_s``): an extent slower than the threshold is read a second
  time in parallel and the first finisher wins (Dean & Barroso's
  tail-at-scale trick), with the loser cancelled cooperatively via
  :class:`CancelledRead`.

* :class:`CorruptRecordError` — the structured integrity failure: names
  the record, its file offset, and both checksums.  Subclasses
  ``IOError`` so existing error handling keeps working.

* :func:`checksum32` — the RREC v2 per-record checksum.  CRC32C
  (Castagnoli) via the optional hardware-accelerated ``crc32c`` package
  when importable, ``zlib.crc32`` otherwise; the file header records
  which algorithm produced the table so readers never mix them.
"""
from __future__ import annotations

import errno
import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import trace as _trace

try:  # optional hardware CRC32C; the container usually has only zlib
    from crc32c import crc32c as checksum32  # type: ignore

    CHECKSUM_ALGORITHM = "crc32c"
except ImportError:  # pragma: no cover - environment-dependent
    checksum32 = zlib.crc32
    CHECKSUM_ALGORITHM = "crc32"

# errno values the retry layer treats as transient.  EIO is included:
# on real NVMe a one-off EIO is routinely a link-level transient, and a
# genuinely dead region simply keeps failing until the bounded retry
# budget is exhausted — one mechanism covers both.
TRANSIENT_ERRNOS = frozenset(
    {errno.EINTR, errno.EAGAIN, errno.EWOULDBLOCK, errno.EIO}
)


class CorruptRecordError(IOError):
    """A record's payload failed checksum verification *and* a one-shot
    re-read of it failed again: the bytes on the medium are wrong."""

    def __init__(
        self,
        path: str,
        record: int,
        offset: int,
        expected: int,
        actual: int,
    ):
        super().__init__(
            f"{path}: record {record} at offset {offset} is corrupt "
            f"(checksum {actual:#010x} != stored {expected:#010x}; "
            f"re-read did not heal it)"
        )
        self.path = path
        self.record = record
        self.offset = offset
        self.expected = expected
        self.actual = actual


class TransientZeroRead(OSError):
    """A zero-length pread strictly before end-of-file.

    Distinct from EOF by construction (the caller checks the file size):
    a genuine EOF means the file is shorter than the plan believed —
    corruption or truncation, never retryable — while a mid-file zero
    read is a transport hiccup the retry policy is allowed to heal.
    """

    def __init__(self, offset: int, done: int, total: int):
        super().__init__(
            errno.EIO,
            f"zero-length pread at offset {offset} mid-file "
            f"({done}/{total} bytes read): transient",
        )
        self.offset = offset


class CancelledRead(Exception):
    """A hedged read lost the race and was cancelled cooperatively.

    Raised out of injected stalls and retry backoffs when the sibling
    read completed first; never surfaces to callers (the hedging layer
    swallows it once the winner's bytes are in place).
    """


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry/hedging policy for transient read faults.

    ``max_retries`` re-attempts per extent with exponential backoff
    (``backoff_s * 2**k``, capped at ``backoff_cap_s``), all under a
    per-batch ``deadline_s``.  ``hedge_s`` (None = off) arms hedged
    reads: an extent chunk that hasn't completed within the threshold is
    issued a second time and the first finisher wins.
    """

    max_retries: int = 4
    backoff_s: float = 0.002
    backoff_cap_s: float = 0.1
    deadline_s: Optional[float] = 30.0
    hedge_s: Optional[float] = None


DEFAULT_RETRY = RetryPolicy()


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a high-quality 64-bit hash, dependency-free."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


@dataclass(frozen=True)
class FaultSpec:
    """Declarative fault schedule (see the module docstring's taxonomy).

    Rates are per pread *attempt*; ``seed`` fixes the whole schedule.
    ``max_faults`` bounds total transient injections (persistent faults
    are a property of the medium and are never budgeted).
    ``stall_once_per_offset`` makes a stalling offset stall only the
    first attempt at it — the device-hiccup model under which retries
    and hedges actually help; set it False for a pathological device.
    """

    seed: int = 0
    transient_rate: float = 0.0
    zero_read_rate: float = 0.0
    short_read_rate: float = 0.0
    bitflip_rate: float = 0.0
    stall_rate: float = 0.0
    stall_s: float = 0.05
    stall_once_per_offset: bool = True
    eio_extents: Tuple[Tuple[int, int], ...] = ()
    corrupt_offsets: Tuple[int, ...] = ()
    max_faults: Optional[int] = None

    _RATE_KEYS = {
        "transient": "transient_rate",
        "zero": "zero_read_rate",
        "short": "short_read_rate",
        "bitflip": "bitflip_rate",
        "stall": "stall_rate",
    }

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        """Parse a ``--chaos`` launch-flag string.

        ``"seed=3,transient=0.05,stall=0.01,stall_s=0.2,eio=4096:8192,
        corrupt=100/2048"`` — comma-separated ``k=v`` pairs; ``eio``
        takes ``offset:length`` extents and ``corrupt`` takes ``/``-
        separated file offsets.
        """
        kw: Dict[str, object] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"--chaos: expected k=v, got {part!r}")
            k, v = part.split("=", 1)
            k = k.strip()
            if k in cls._RATE_KEYS:
                kw[cls._RATE_KEYS[k]] = float(v)
            elif k in ("seed", "max_faults"):
                kw[k] = int(v)
            elif k == "stall_s":
                kw[k] = float(v)
            elif k == "stall_once":
                kw["stall_once_per_offset"] = v.strip() in ("1", "true", "yes")
            elif k == "eio":
                off, ln = v.split(":")
                kw.setdefault("eio_extents", [])
                kw["eio_extents"].append((int(off), int(ln)))  # type: ignore
            elif k == "corrupt":
                kw["corrupt_offsets"] = tuple(
                    int(o) for o in v.split("/") if o
                )
            else:
                raise ValueError(f"--chaos: unknown key {k!r}")
        if "eio_extents" in kw:
            kw["eio_extents"] = tuple(kw["eio_extents"])  # type: ignore
        return cls(**kw)  # type: ignore[arg-type]


# salts separating the independent per-attempt fault rolls
_S_STALL, _S_ERR, _S_ZERO, _S_SHORT, _S_FLIP, _S_PICK = range(6)


@dataclass
class FaultLog:
    """Thread-safe injection counters + the flip locations, for exact
    reconciliation against ``IOStats`` in the chaos suite."""

    transients: int = 0
    zero_reads: int = 0
    short_reads: int = 0
    bitflips: int = 0
    stalls: int = 0
    eio_hits: int = 0
    flip_offsets: List[int] = field(default_factory=list)

    @property
    def retryable(self) -> int:
        """Faults that force the retry layer to re-attempt an extent —
        the number ``IOStats.retries`` reconciles against when no retry
        budget is exhausted (errors and zero reads; short reads are
        continued, not retried, and stalls/flips return data)."""
        return self.transients + self.zero_reads


class FaultInjector:
    """Deterministic pread-level fault injector (the chaos seam).

    Install on a :class:`~repro_torch.storage.record_store.RecordStore` via
    ``RecordStore(path, fault_injector=...)``; every pread the store
    issues then flows through :meth:`pread`.  Decisions are pure hashes
    of ``(seed, offset, attempt#)`` — the per-offset attempt counter is
    the only mutable state, so two runs with the same seed inject the
    same faults regardless of thread interleaving.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.log = FaultLog()
        self._lock = threading.Lock()
        self._attempts: Dict[int, int] = {}
        self._budget_used = 0
        self._corrupt = tuple(sorted(spec.corrupt_offsets))

    # ------------------------------------------------------------ helpers
    def _u01(self, offset: int, attempt: int, salt: int) -> float:
        h = _mix64(
            (self.spec.seed * 0x9E3779B97F4A7C15)
            ^ (offset * 0xD1342543DE82EF95)
            ^ (attempt * 0xAF251AF3B0F025B5)
            ^ salt
        )
        return h / 2.0**64

    def _hash_int(self, offset: int, attempt: int, salt: int, mod: int) -> int:
        return _mix64(
            (self.spec.seed * 0x2545F4914F6CDD1D)
            ^ (offset * 0x9E3779B97F4A7C15)
            ^ (attempt * 0xD1342543DE82EF95)
            ^ salt
        ) % max(1, mod)

    def _take_budget(self) -> bool:
        """Consume one unit of the transient-fault budget (thread-safe)."""
        if self.spec.max_faults is None:
            return True
        with self._lock:
            if self._budget_used >= self.spec.max_faults:
                return False
            self._budget_used += 1
            return True

    def _count(self, name: str, n: int = 1):
        with self._lock:
            setattr(self.log, name, getattr(self.log, name) + n)
        # every injected fault funnels through here: one instant per
        # fault marks the injection on the trace timeline, so retries/
        # hedges in the storage lane line up with their cause
        if _trace.enabled():
            _trace.instant("storage/fault_injected", "storage",
                           args={"kind": name, "n": n})

    # -------------------------------------------------------------- seam
    def pread(
        self,
        fd: int,
        view: memoryview,
        offset: int,
        cancel: Optional[threading.Event] = None,
        recovery: bool = False,
    ) -> int:
        """The injected ``os.preadv``: serve ``len(view)`` bytes at
        ``offset`` into ``view``, with faults per the spec.  ``cancel``
        makes injected stalls cooperative (a hedged sibling that wins
        the race sets it and the stall aborts with
        :class:`CancelledRead`).  ``recovery=True`` marks a checksum
        re-read: transient classes are skipped, persistent ones apply.
        """
        spec = self.spec
        length = len(view)
        # persistent dead regions fail every attempt, recovery included
        for eoff, eln in spec.eio_extents:
            if offset < eoff + eln and eoff < offset + length:
                self._count("eio_hits")
                raise OSError(
                    errno.EIO,
                    f"injected persistent EIO on extent "
                    f"[{eoff}, {eoff + eln})",
                )
        with self._lock:
            attempt = self._attempts.get(offset, 0)
            self._attempts[offset] = attempt + 1
        if not recovery:
            if (
                spec.stall_rate > 0.0
                and (attempt == 0 or not spec.stall_once_per_offset)
                and self._u01(offset, attempt, _S_STALL) < spec.stall_rate
                and self._take_budget()
            ):
                self._count("stalls")
                if cancel is not None:
                    if cancel.wait(spec.stall_s):
                        raise CancelledRead()
                else:
                    import time

                    time.sleep(spec.stall_s)
            if (
                spec.transient_rate > 0.0
                and self._u01(offset, attempt, _S_ERR) < spec.transient_rate
                and self._take_budget()
            ):
                self._count("transients")
                eno = (errno.EINTR, errno.EAGAIN, errno.EIO)[
                    self._hash_int(offset, attempt, _S_ERR, 3)
                ]
                raise OSError(eno, f"injected transient {errno.errorcode[eno]}")
            if (
                spec.zero_read_rate > 0.0
                and self._u01(offset, attempt, _S_ZERO) < spec.zero_read_rate
                and self._take_budget()
            ):
                self._count("zero_reads")
                return 0
        got = os.preadv(fd, [view], offset)
        if got > 0 and not recovery:
            if (
                spec.short_read_rate > 0.0
                and got > 1
                and self._u01(offset, attempt, _S_SHORT) < spec.short_read_rate
                and self._take_budget()
            ):
                self._count("short_reads")
                got = 1 + self._hash_int(offset, attempt, _S_SHORT, got - 1)
            if (
                spec.bitflip_rate > 0.0
                and self._u01(offset, attempt, _S_FLIP) < spec.bitflip_rate
                and self._take_budget()
            ):
                j = self._hash_int(offset, attempt, _S_FLIP, got)
                bit = self._hash_int(offset, attempt, _S_PICK, 8)
                view[j] = view[j] ^ (1 << bit)
                with self._lock:
                    self.log.bitflips += 1
                    self.log.flip_offsets.append(offset + j)
        # persistent media corruption: these file bytes always read flipped
        if self._corrupt and got > 0:
            import bisect

            lo = bisect.bisect_left(self._corrupt, offset)
            hi = bisect.bisect_left(self._corrupt, offset + got)
            for o in self._corrupt[lo:hi]:
                view[o - offset] = view[o - offset] ^ 0x01
        return got

    # ------------------------------------------------------------ report
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "transients": self.log.transients,
                "zero_reads": self.log.zero_reads,
                "short_reads": self.log.short_reads,
                "bitflips": self.log.bitflips,
                "stalls": self.log.stalls,
                "eio_hits": self.log.eio_hits,
            }
