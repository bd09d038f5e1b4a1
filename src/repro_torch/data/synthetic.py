"""Synthetic datasets mirroring the paper's Table 1 workloads (scaled).

Classification sets (SVM/DNN): linearly-separable-with-noise mixtures so
convergence behaviour under different shuffling regimes is measurable.
Sparse variants store (index,value) pairs of varying length (webspam/kdd
style); dense variants store fixed float32 vectors (epsilon/higgs style).
Token sets feed the LM training examples.

Record encodings:
    dense:  label f32 || features f32[dim]                (fixed size)
    sparse: label f32 || nnz u32 || idx u32[nnz] || val f32[nnz]  (variable)
    tokens: int32[seq_len + 1]                            (fixed size)
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

import numpy as np

from repro_torch.storage.record_store import RecordWriter


@dataclasses.dataclass
class DatasetMeta:
    path: str
    num_records: int
    dim: int
    sparse: bool
    avg_record_bytes: float
    total_bytes: float
    seq_len: int = 0
    vocab: int = 0


def _separable_labels(x: np.ndarray, w: np.ndarray, noise: float, rng) -> np.ndarray:
    margin = x @ w
    y = np.sign(margin)
    flip = rng.random(len(y)) < noise
    y[flip] *= -1
    y[y == 0] = 1
    return y.astype(np.float32)


def make_classification_dataset(
    path: str,
    num_records: int,
    dim: int,
    sparse: bool = False,
    nnz_range: Tuple[int, int] = (8, 64),
    noise: float = 0.05,
    seed: int = 0,
) -> DatasetMeta:
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=dim) / np.sqrt(dim)
    total = 0
    if sparse:
        with RecordWriter(path) as w:
            for _ in range(num_records):
                nnz = int(rng.integers(nnz_range[0], nnz_range[1] + 1))
                idx = rng.choice(dim, size=nnz, replace=False).astype(np.uint32)
                val = rng.normal(size=nnz).astype(np.float32)
                # the margin from the nonzeros alone (ids are distinct): a
                # dense x per record would cost O(dim) at webspam width.
                # Same rng draws as the dense form, so the same file.
                y = _separable_labels(val[None], w_true[idx], noise, rng)[0]
                rec = struct.pack("<fI", y, nnz) + idx.tobytes() + val.tobytes()
                w.append(rec)
                total += len(rec)
    else:
        rec_size = 4 + 4 * dim
        with RecordWriter(path, record_size=rec_size) as w:
            for _ in range(num_records):
                x = rng.normal(size=dim).astype(np.float32)
                y = _separable_labels(x[None], w_true, noise, rng)[0]
                w.append(struct.pack("<f", y) + x.tobytes())
                total += rec_size
    return DatasetMeta(
        path=path,
        num_records=num_records,
        dim=dim,
        sparse=sparse,
        avg_record_bytes=total / num_records,
        total_bytes=float(total),
    )


def make_token_dataset(
    path: str, num_records: int, seq_len: int, vocab: int, seed: int = 0
) -> DatasetMeta:
    """Synthetic LM corpus with learnable bigram structure (so loss drops)."""
    rng = np.random.default_rng(seed)
    # low-entropy bigram transition table
    trans = rng.integers(0, vocab, size=(vocab, 4))
    rec_size = 4 * (seq_len + 1)
    with RecordWriter(path, record_size=rec_size) as w:
        for _ in range(num_records):
            toks = np.empty(seq_len + 1, np.int32)
            toks[0] = rng.integers(vocab)
            for t in range(1, seq_len + 1):
                if rng.random() < 0.8:
                    toks[t] = trans[toks[t - 1], rng.integers(4)]
                else:
                    toks[t] = rng.integers(vocab)
            w.append(toks.tobytes())
    return DatasetMeta(
        path=path,
        num_records=num_records,
        dim=0,
        sparse=False,
        avg_record_bytes=rec_size,
        total_bytes=float(rec_size * num_records),
        seq_len=seq_len,
        vocab=vocab,
    )


# ------------------------------------------------------------- decoders


def decode_dense(raw: bytes, dim: int) -> Tuple[np.float32, np.ndarray]:
    y = struct.unpack_from("<f", raw, 0)[0]
    x = np.frombuffer(raw, np.float32, count=dim, offset=4)
    return y, x


def decode_sparse(raw: bytes, dim: int) -> Tuple[np.float32, np.ndarray]:
    y, nnz = struct.unpack_from("<fI", raw, 0)
    idx = np.frombuffer(raw, np.uint32, count=nnz, offset=8)
    val = np.frombuffer(raw, np.float32, count=nnz, offset=8 + 4 * nnz)
    x = np.zeros(dim, np.float32)
    # accumulate (not overwrite) duplicate ids: CSR semantics, identical
    # to the ragged-arena fast path (repro_torch.svm.sparse.csr_to_dense)
    np.add.at(x, idx.astype(np.int64), val)
    return y, x


def decode_dense_batch(raws, dim: int):
    if isinstance(raws, np.ndarray):
        # dense (B, record_size) uint8 matrix from read_batch_into:
        # reinterpret in place, no per-record Python.  NOTE: xs aliases
        # `raws` — pass a fresh (non-recycled) buffer or copy before reuse.
        m = np.ascontiguousarray(raws).view(np.float32)
        return m[:, 1 : 1 + dim], m[:, 0].copy()
    ys = np.empty(len(raws), np.float32)
    xs = np.empty((len(raws), dim), np.float32)
    for i, r in enumerate(raws):
        ys[i], xs[i] = decode_dense(r, dim)
    return xs, ys


def decode_sparse_batch(raws, dim: int):
    from repro_torch.storage.record_store import RaggedBatch

    if isinstance(raws, RaggedBatch):
        # arena fast path: vectorized CSR parse (repro_torch.svm.sparse), then
        # densify — no per-record Python
        from repro_torch.svm.sparse import csr_to_dense, pack_csr_batch

        return csr_to_dense(pack_csr_batch(raws, dim), dim)
    ys = np.empty(len(raws), np.float32)
    xs = np.empty((len(raws), dim), np.float32)
    for i, r in enumerate(raws):
        ys[i], xs[i] = decode_sparse(r, dim)
    return xs, ys


def decode_tokens(raw: bytes, seq_len: int) -> np.ndarray:
    return np.frombuffer(raw, np.int32, count=seq_len + 1)


def decode_token_batch(raws, seq_len: int):
    if isinstance(raws, np.ndarray):
        # zero-copy reinterpret of the coalesced read's dense buffer;
        # truncate to seq_len+1 like the per-record path does
        toks = np.ascontiguousarray(raws).view(np.int32)[:, : seq_len + 1]
    else:
        toks = np.stack([decode_tokens(r, seq_len) for r in raws])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
