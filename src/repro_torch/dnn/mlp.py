"""Small MLP classifier substrate (the paper's DNN workload, CPU-scaled).

Multiclass softmax MLP trained with mini-batch SGD+momentum; used by the
DNN convergence/accuracy runs to compare TFIP (bounded shuffle queue)
against LIRS (full re-shuffle) exactly as §5.3 does for
AlexNet/OverFeat/VGG16 on ImageNet.

The port of ``repro.dnn.mlp``.  The parameters are a list of
``{"w": (a, b), "b": (b,)}`` f32 tensors, the JAX layout, so
``models.weights.params_from_jax`` carries the reference's across; the
gradients come from autograd where the reference uses
``jax.value_and_grad``, and the momentum update is done in place.  The
matrix products stay ``torch.matmul``: the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def init_params(dims, seed: int, device) -> list:
    """``w ~ N(0, 1/a)``, ``b = 0`` per layer, from a torch generator (its
    numbers differ from ``jax.random``'s; tests carry JAX's across)."""
    g = torch.Generator().manual_seed(seed)
    return [
        {"w": (torch.randn(a, b, generator=g) / np.sqrt(a)).to(device),
         "b": torch.zeros(b, device=device)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def _forward(params, x):
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    out = params[-1]
    return x @ out["w"] + out["b"]


def _loss(params, x, y):
    logp = torch.log_softmax(_forward(params, x), dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


class MLPClassifier:
    def __init__(self, dim: int, num_classes: int, hidden=(64, 64), seed: int = 0,
                 lr: float = 0.05, momentum: float = 0.9, device="cuda", params=None):
        self.device = resolve_device(device)
        if params is None:
            params = init_params((dim, *hidden, num_classes), seed, self.device)
        self.params = [{k: v.to(self.device, torch.float32).clone().requires_grad_(True)
                        for k, v in layer.items()} for layer in params]
        self._leaves = [layer[k] for layer in self.params for k in ("w", "b")]
        self._vel = [torch.zeros_like(p) for p in self._leaves]
        self.lr, self.momentum = lr, momentum

    def _tensor(self, a, dtype):
        return torch.as_tensor(a).to(self.device, dtype)

    def train_batch(self, x, y) -> float:
        """One step: ``vel = mom·vel + g``, ``p −= lr·vel``; returns the
        batch's mean NLL before the step, as ``float`` (a device sync)."""
        x, y = self._tensor(x, torch.float32), self._tensor(y, torch.int32)
        loss = _loss(self.params, x, y)
        grads = torch.autograd.grad(loss, self._leaves)
        with torch.no_grad():
            torch._foreach_mul_(self._vel, self.momentum)
            torch._foreach_add_(self._vel, grads)
            torch._foreach_sub_(self._leaves, torch._foreach_mul(self._vel, self.lr))
        return float(loss.detach())

    @torch.no_grad()
    def loss(self, x, y) -> float:
        return float(_loss(self.params, self._tensor(x, torch.float32),
                           self._tensor(y, torch.int32)))

    @torch.no_grad()
    def accuracy(self, x, y) -> float:
        pred = _forward(self.params, self._tensor(x, torch.float32)).argmax(-1)
        return int((pred == self._tensor(y, torch.int64)).sum()) / pred.numel()


def make_clustered_data(
    n: int, dim: int, num_classes: int, seed: int = 0, class_sorted: bool = True,
    spread: float = 1.0, centers: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gaussian class clusters.  ``class_sorted=True`` stores instances in
    class order — the on-disk layout (ImageNet-style) that makes bounded
    shuffle queues lose accuracy (paper Fig 3).  Pass ``centers`` to draw a
    matched test split.  Returns (xs, ys, centers)."""
    rng = np.random.default_rng(seed)
    if centers is None:
        centers = rng.normal(size=(num_classes, dim)) * spread
    ys = np.repeat(np.arange(num_classes), n // num_classes)
    xs = centers[ys] + rng.normal(size=(len(ys), dim))
    if not class_sorted:
        order = rng.permutation(len(ys))
        xs, ys = xs[order], ys[order]
    return xs.astype(np.float32), ys.astype(np.int32), centers
