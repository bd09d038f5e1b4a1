"""Random assignment tables: which instance lands in which batch, per epoch.

``TableAssignment`` is the paper-faithful design: an explicit in-memory
permutation of all N instance IDs, re-drawn each epoch (memory: N×8 B —
the paper's Table 5 'Random Assign Table').

``FeistelAssignment`` is our beyond-paper design for 1000+-node scale: a
keyed 4-round Feistel network over [0, 2^k) with cycle-walking gives a
bijective pseudorandom permutation of [0, N) computable *pointwise* in
O(1) memory.  Every host derives any epoch's assignment from (seed, epoch)
alone — nothing to store, broadcast, or checkpoint, and elastic re-sharding
is a pure index remap (DESIGN.md §3).
"""
from __future__ import annotations

import numpy as np

_MASK32 = np.uint64(0xFFFFFFFF)


class TableAssignment:
    """Explicit per-epoch permutation (paper §4.1)."""

    kind = "table"

    def __init__(self, num_items: int, seed: int = 0):
        self.num_items = int(num_items)
        self.seed = int(seed)
        self._cache_epoch = -1
        self._cache: np.ndarray | None = None

    def epoch_permutation(self, epoch: int) -> np.ndarray:
        if epoch != self._cache_epoch:
            rng = np.random.default_rng((self.seed, epoch))
            self._cache = rng.permutation(self.num_items).astype(np.int64)
            self._cache_epoch = epoch
        return self._cache

    def index_at(self, epoch: int, slots) -> np.ndarray:
        return self.epoch_permutation(epoch)[np.asarray(slots, dtype=np.int64)]

    @property
    def nbytes(self) -> int:
        return self.num_items * 8  # the paper's accounting: N × 8 B


class FeistelAssignment:
    """O(1)-memory keyed bijection over [0, N) via cycle-walking Feistel."""

    kind = "feistel"
    ROUNDS = 4

    def __init__(self, num_items: int, seed: int = 0):
        self.num_items = int(num_items)
        self.seed = int(seed)
        bits = max(2, int(np.ceil(np.log2(max(2, num_items)))))
        if bits % 2:
            bits += 1
        self.bits = bits
        self.half_bits = bits // 2
        self.half_mask = np.uint64((1 << self.half_bits) - 1)
        self.domain = 1 << bits

    def _keys(self, epoch: int) -> np.ndarray:
        # derive per-round keys from (seed, epoch) with splitmix64
        mix = (
            self.seed * 0x9E3779B97F4A7C15
            + epoch * 0xBF58476D1CE4E5B9
            + 0x94D049BB133111EB
        ) & 0xFFFFFFFFFFFFFFFF
        x = np.uint64(mix)
        keys = np.empty(self.ROUNDS, dtype=np.uint64)
        with np.errstate(over="ignore"):  # uint64 wraparound is intended
            for r in range(self.ROUNDS):
                x = x + np.uint64(0x9E3779B97F4A7C15)
                z = x
                z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
                z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
                keys[r] = z ^ (z >> np.uint64(31))
        return keys

    def _round(self, half: np.ndarray, key: np.uint64) -> np.ndarray:
        # xorshift-multiply round function on the half-block
        with np.errstate(over="ignore"):  # uint64 wraparound is intended
            z = half + key
            z = (z ^ (z >> np.uint64(16))) * np.uint64(0x45D9F3B)
            z = (z ^ (z >> np.uint64(16))) * np.uint64(0x45D9F3B)
        return (z ^ (z >> np.uint64(16))) & self.half_mask

    def _permute_once(self, x: np.ndarray, keys: np.ndarray) -> np.ndarray:
        left = (x >> np.uint64(self.half_bits)) & self.half_mask
        right = x & self.half_mask
        for r in range(self.ROUNDS):
            left, right = right, left ^ self._round(right, keys[r])
        return (left << np.uint64(self.half_bits)) | right

    def index_at(self, epoch: int, slots) -> np.ndarray:
        keys = self._keys(epoch)
        x = np.asarray(slots, dtype=np.uint64)
        scalar = x.ndim == 0
        x = np.atleast_1d(x)
        out = self._permute_once(x, keys)
        # cycle-walk values that fell outside [0, N)
        bad = out >= np.uint64(self.num_items)
        guard = 0
        while bad.any():
            out[bad] = self._permute_once(out[bad], keys)
            bad = out >= np.uint64(self.num_items)
            guard += 1
            if guard > 64 * self.bits:  # pragma: no cover - mathematically bounded
                raise RuntimeError("cycle walking failed to terminate")
        res = out.astype(np.int64)
        return res[0] if scalar else res

    def epoch_permutation(self, epoch: int) -> np.ndarray:
        return self.index_at(epoch, np.arange(self.num_items, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return 8 * (self.ROUNDS + 2)  # keys + metadata: O(1)
