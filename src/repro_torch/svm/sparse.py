"""CSR batch packing for sparse SVM instances (webspam/kdd style).

The record encoding (see repro_torch.data.synthetic) is

    label f32 || nnz u32 || idx u32[nnz] || val f32[nnz]

``pack_csr_batch`` parses a whole ragged arena batch
(:class:`~repro_torch.storage.record_store.RaggedBatch`) into CSR arrays —
``(indices, values, row_ptr, labels)`` — with three vectorized gathers and
zero per-record Python, so the host-side packing path is as lean as the
ragged read path that feeds it.  The same function accepts ``List[bytes]``
(the seed read path) through a per-record reference loop, which doubles as
the parity oracle for the vectorized path.

``pad_csr`` rectangularizes a CSR batch to ``(B, K)`` index/value arrays
(pad index 0, pad value 0.0 — an exact no-op for any inner product), the
shape the Pallas ``csr_dot`` kernel consumes on-device.
"""
from __future__ import annotations

import struct
from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np

from repro_torch.storage.record_store import RaggedBatch


class CSRBatch(NamedTuple):
    """One batch of sparse instances in CSR form (host or device ready).

    Row ``j``'s nonzeros live at ``indices[row_ptr[j]:row_ptr[j+1]]`` /
    ``values[row_ptr[j]:row_ptr[j+1]]``.
    """

    indices: np.ndarray  # int32 (nnz_total,) feature ids
    values: np.ndarray   # float32 (nnz_total,)
    row_ptr: np.ndarray  # int32 (B + 1,) exclusive prefix sum of row nnz
    labels: np.ndarray   # float32 (B,)

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])


def _segmented_arange(counts: np.ndarray, total: int) -> np.ndarray:
    """``[0..c0-1, 0..c1-1, ...]`` without a Python loop."""
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def _checked_int32_ids(u32: np.ndarray, dim: int) -> np.ndarray:
    """Validate u32 feature ids *before* the int32 cast: ids >= 2^31 would
    wrap negative (an id of 2^32−1 becomes −1, a silently *valid* index
    into ``w`` downstream) and ids >= dim are out of range."""
    if u32.size:
        top = int(u32.max())
        if dim and top >= dim:
            raise ValueError("feature index out of range")
        if top > np.iinfo(np.int32).max:
            raise ValueError("feature index exceeds the int32 CSR contract")
    return u32.astype(np.int32)


def _pack_bytes(raws: Sequence[bytes], dim: int) -> CSRBatch:
    """Per-record reference parser (the parity oracle)."""
    b = len(raws)
    labels = np.empty(b, np.float32)
    row_nnz = np.empty(b, np.int64)
    idx_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    for j, raw in enumerate(raws):
        y, nnz = struct.unpack_from("<fI", raw, 0)
        labels[j] = y
        row_nnz[j] = nnz
        idx_parts.append(np.frombuffer(raw, np.uint32, count=nnz, offset=8))
        val_parts.append(
            np.frombuffer(raw, np.float32, count=nnz, offset=8 + 4 * nnz)
        )
    row_ptr = np.zeros(b + 1, np.int32)
    np.cumsum(row_nnz, out=row_ptr[1:])
    indices = _checked_int32_ids(
        np.concatenate(idx_parts) if idx_parts else np.empty(0, np.uint32),
        dim,
    )
    values = (
        np.concatenate(val_parts) if val_parts else np.empty(0, np.float32)
    )
    return CSRBatch(indices, values, row_ptr, labels)


def pack_csr_batch(
    batch: Union[RaggedBatch, Sequence[bytes]], dim: int = 0
) -> CSRBatch:
    """Parse a batch of sparse records into CSR arrays.

    For a :class:`RaggedBatch` the parse is fully vectorized: record
    lengths give each row's nnz arithmetically (``len = 8 + 8*nnz``), the
    stored nnz field is cross-checked in one gather, and the index/value
    payloads land via two flat fancy-index gathers over the arena.
    ``dim > 0`` additionally validates feature ids.
    """
    if not isinstance(batch, RaggedBatch):
        return _pack_bytes(batch, dim)
    arena, offsets, lengths = batch
    b = len(offsets)
    if b == 0:
        return CSRBatch(
            np.empty(0, np.int32),
            np.empty(0, np.float32),
            np.zeros(1, np.int32),
            np.empty(0, np.float32),
        )
    off64 = offsets.astype(np.int64)
    len64 = lengths.astype(np.int64)
    if ((len64 < 8) | ((len64 - 8) % 8 != 0)).any():
        raise ValueError("record length is not 8 + 8*nnz — not sparse SVM data")
    row_nnz = (len64 - 8) // 8
    # every record is 8 + 8*nnz bytes and the arena is packed, so all
    # offsets are 8-aligned: parse in uint32 *words* (4× fewer gather
    # elements than bytes — same trick as read_batch_ragged's fast path)
    arena32 = arena.view(np.uint32)
    word_off = off64 >> 2
    # header gather: (B, 2) words -> label f32 + stored nnz u32
    head = arena32[word_off[:, None] + np.arange(2)]
    labels = head[:, 0].copy().view(np.float32)
    stored_nnz = head[:, 1]
    if not np.array_equal(stored_nnz, row_nnz.astype(np.uint32)):
        raise ValueError("stored nnz disagrees with record length")
    total = int(row_nnz.sum())
    row_ptr = np.zeros(b + 1, np.int32)
    np.cumsum(row_nnz, out=row_ptr[1:])
    # two flat word gathers: the index section then the value section
    within = _segmented_arange(row_nnz, total)
    idx_src = np.repeat(word_off + 2, row_nnz) + within
    indices = _checked_int32_ids(arena32[idx_src], dim)
    values = arena32[idx_src + np.repeat(row_nnz, row_nnz)].view(np.float32)
    return CSRBatch(indices, values, row_ptr, labels)


def pad_csr(
    csr: CSRBatch, k: int = 0, multiple: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Rectangularize to ``(B, K)`` padded index/value arrays for the
    Pallas ``csr_dot`` kernel.

    Padding uses index 0 with value 0.0, which contributes exactly
    ``0.0 * w[0] == 0.0`` to any inner product (bit-exact no-op for
    finite weights).  ``k`` forces the row capacity; otherwise the max
    row nnz is rounded up to ``multiple`` (lane-friendly on TPU).
    """
    b = len(csr)
    row_nnz = np.diff(csr.row_ptr).astype(np.int64)
    need = int(row_nnz.max()) if b else 0
    if k:
        if k < need:
            raise ValueError(f"k={k} < max row nnz {need}")
    else:
        k = max(multiple, -(-need // multiple) * multiple)
    idx2d = np.zeros((b, k), np.int32)
    val2d = np.zeros((b, k), np.float32)
    total = int(row_nnz.sum())
    rows = np.repeat(np.arange(b, dtype=np.int64), row_nnz)
    cols = _segmented_arange(row_nnz, total)
    idx2d[rows, cols] = csr.indices
    val2d[rows, cols] = csr.values
    return idx2d, val2d


def csr_to_dense(csr: CSRBatch, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Densify to ``(xs, ys)`` — the shape the seed decoders produce.

    Duplicate feature ids within a row accumulate (matching the inner
    product the CSR paths compute).
    """
    b = len(csr)
    xs = np.zeros((b, dim), np.float32)
    rows = np.repeat(
        np.arange(b, dtype=np.int64), np.diff(csr.row_ptr).astype(np.int64)
    )
    np.add.at(xs, (rows, csr.indices.astype(np.int64)), csr.values)
    return xs, csr.labels.copy()
