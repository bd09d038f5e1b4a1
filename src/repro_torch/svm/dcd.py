"""Dual coordinate descent for L2-loss (squared-hinge) linear SVM —
the LIBLINEAR algorithm the paper's BMF baseline uses (Hsieh et al. 2008).

Block-minimization training (Yu et al. 2012): load one block of instances,
run ``sweeps`` DCD passes over its dual variables, move to the next block.
The dual variables persist across epochs; only the *block composition*
differs between BMF (fixed random partition) and LIRS (fresh partition per
epoch) — which is exactly the variable the paper studies.

``solve_block_csr`` consumes CSR batches straight off the ragged read
path (repro_torch.svm.sparse) without densifying: the sequential dual updates
touch only each instance's nonzeros, and the O(B·nnz) batch inner
products (``margins_csr``) run on the solver's device through the
``csr_dot`` kernel (``repro_torch.kernels.ops``).

The coordinate loop is the JAX package's numpy loop unchanged, so ``w``
and ``alpha`` are bit-identical to ``repro.svm.dcd.DCDSolver``'s; only
the batch inner products moved from the Pallas kernel to the CUDA one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import trace as _trace
from repro_torch.svm.sparse import pad_csr


class DCDSolver:
    def __init__(self, dim: int, n: int, C: float = 1.0, device="cuda"):
        self.C = C
        self.w = np.zeros(dim)
        self.alpha = np.zeros(n)
        self.device = resolve_device(device)

    def solve_block(self, xs: np.ndarray, ys: np.ndarray, idx: np.ndarray, sweeps: int = 5):
        """Run DCD sweeps over the dual coordinates of one block."""
        w, alpha, C = self.w, self.alpha, self.C
        xb = xs[idx]
        yb = ys[idx]
        xsq = (xb * xb).sum(1) + 1.0 / (2 * C)
        for _ in range(sweeps):
            for j, i in enumerate(idx):
                g = yb[j] * (xb[j] @ w) - 1.0 + alpha[i] / (2 * C)
                if alpha[i] > 0 or g < 0:
                    na = max(alpha[i] - g / xsq[j], 0.0)
                    if na != alpha[i]:
                        w += (na - alpha[i]) * yb[j] * xb[j]
                        alpha[i] = na

    def solve_block_csr(self, csr, idx: np.ndarray, sweeps: int = 5):
        """DCD sweeps over one block of CSR instances (no densification).

        ``csr`` is a :class:`repro_torch.svm.sparse.CSRBatch` whose row ``j``
        is global instance ``idx[j]`` (the dual coordinate it owns).
        Labels come from the batch itself — the ragged read path carries
        them inside each record.  Identical update rule to
        :meth:`solve_block`; each coordinate step touches only the
        instance's nonzeros, so a sweep is O(block nnz), not O(B·dim).
        """
        w, alpha, C = self.w, self.alpha, self.C
        rp = csr.row_ptr
        cols = csr.indices.astype(np.int64)
        vals = csr.values.astype(np.float64)
        yb = csr.labels.astype(np.float64)
        xsq = self._row_sq_norms(rp, cols, vals) + 1.0 / (2 * C)
        for _ in range(sweeps):
            for j, i in enumerate(idx):
                s, e = rp[j], rp[j + 1]
                cj = cols[s:e]
                vj = vals[s:e]
                g = yb[j] * (vj @ w[cj]) - 1.0 + alpha[i] / (2 * C)
                if alpha[i] > 0 or g < 0:
                    na = max(alpha[i] - g / xsq[j], 0.0)
                    if na != alpha[i]:
                        # np.add.at, not fancy +=: a row listing the same
                        # feature twice must accumulate both coefficients
                        # (CSR semantics, matching csr_to_dense / csr_dot)
                        np.add.at(w, cj, (na - alpha[i]) * yb[j] * vj)
                        alpha[i] = na

    @staticmethod
    def _row_sq_norms(rp, cols, vals) -> np.ndarray:
        """Per-row ||x_j||² under CSR accumulate semantics: duplicate
        feature ids sum *before* squaring (exactly what densification
        yields), so the coordinate minimizer's denominator matches the
        dense solver bit-for-bit on duplicate-bearing rows too."""
        b = len(rp) - 1
        nnz = len(cols)
        if nnz == 0:
            return np.zeros(b)
        rows = np.repeat(np.arange(b), np.diff(rp).astype(np.int64))
        perm = np.lexsort((cols, rows))
        rc, cc, vv = rows[perm], cols[perm], vals[perm]
        starts = np.flatnonzero(
            np.concatenate(
                ([True], (rc[1:] != rc[:-1]) | (cc[1:] != cc[:-1]))
            )
        )
        combined = np.add.reduceat(vv, starts)
        return np.bincount(rc[starts], combined * combined, minlength=b)

    def margins_csr(self, csr) -> np.ndarray:
        """Batch inner products ``X w`` on the solver's device: the padded
        CSR rows and ``w`` (as f32) go over, one ``csr_dot``, the margins
        come back as numpy.  Spans ``svm/pad``, ``svm/h2d`` and
        ``svm/csr_dot`` time the three host stages when tracing is on."""
        with _trace.span("svm/pad", "svm"):
            idx2d, val2d = pad_csr(csr)
            w32 = self.w.astype(np.float32)
        with _trace.span("svm/h2d", "svm"):
            idx, val, w = (
                torch.from_numpy(a).to(self.device) for a in (idx2d, val2d, w32)
            )
        with _trace.span("svm/csr_dot", "svm"):
            return ops.csr_dot(idx, val, w).cpu().numpy()

    def primal_objective_csr(self, csr) -> float:
        """Squared-hinge primal on one CSR batch, margins via the kernel."""
        m = np.maximum(0.0, 1.0 - csr.labels * self.margins_csr(csr))
        return float(0.5 * self.w @ self.w + self.C * (m * m).sum())

    def primal_objective(self, xs: np.ndarray, ys: np.ndarray) -> float:
        m = np.maximum(0.0, 1.0 - ys * (xs @ self.w))
        return float(0.5 * self.w @ self.w + self.C * (m * m).sum())

    def accuracy(self, xs: np.ndarray, ys: np.ndarray) -> float:
        pred = np.sign(xs @ self.w)
        pred[pred == 0] = 1
        return float((pred == ys).mean())
