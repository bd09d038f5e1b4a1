"""A dataset table held in device memory, gathered into batches by the
LIRS kernels.

The JAX DNN runs (``benchmarks/dnn_convergence.py``, ``queue_size.py``)
build every batch on the host as ``xs[idx]``, ``ys[idx]`` and hand the
numpy arrays to the model.  The port keeps the features and labels on
the device once and does that indexing there.  With ``gather="block"``,
``batch(idx)`` makes one ``ops.batch_gather_tables`` launch for both
tables, the batch's host ids (up to 960) carried in the launch's
parameters, with no copy of them first.  With ``gather="dma"`` it copies the ids to the device
(one small copy) and makes two ``ops.batch_gather_dma`` launches, one for
the features and one for the labels.  The gathers copy bytes, so a batch
equals ``xs[idx]``, ``ys[idx]``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

GATHERS = ("block", "dma")


class DeviceTable:
    def __init__(self, xs, ys, device="cuda", gather: str = "block", rows_per_step: int = 8):
        if gather not in GATHERS:
            raise ValueError(f"gather must be one of {GATHERS}, got {gather!r}")
        if len(xs) != len(ys):
            raise ValueError(f"{len(xs)} feature rows but {len(ys)} labels")
        self.device = resolve_device(device)
        self.gather, self.rows_per_step = gather, rows_per_step
        # (N, DIM) f32 features and (N, 1) int32 labels
        self.x = torch.from_numpy(np.ascontiguousarray(xs, np.float32)).to(self.device)
        self.y = torch.from_numpy(np.ascontiguousarray(ys, np.int32).reshape(-1, 1)).to(self.device)
        self.rows = 0  # rows gathered so far

    def __len__(self) -> int:
        return self.x.shape[0]

    def batch(self, idx):
        """(x (B, DIM) f32, y (B,) int32) on the device for record ids
        ``idx`` (in ``[0, N)``)."""
        i = torch.from_numpy(np.asarray(idx).astype(np.int32))
        self.rows += i.shape[0]
        if self.gather == "block":
            x, y = ops.batch_gather_tables((self.x, self.y), i)
        else:
            i = i.to(self.device)
            x, y = (ops.batch_gather_dma(t, i, rows_per_step=self.rows_per_step)
                    for t in (self.x, self.y))
        return x, y[:, 0]
