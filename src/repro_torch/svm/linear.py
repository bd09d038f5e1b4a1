"""Linear SVM substrate (the paper's SVM workload).

L2-regularized squared-hinge (LIBLINEAR's L2-loss SVM objective):

    f(w) = λ/2 ||w||² + (1/N) Σ max(0, 1 − y_i w·x_i)²

trained with mini-batch gradient descent.  BMF trains a *block* at a time
with several inner passes (mimicking the block-minimization framework);
LIRS feeds freshly re-shuffled batches each epoch.  The convergence metric
is the paper's *relative function value difference* (f − f*)/f*.

The port of ``repro.svm.linear``: the parameters are f32 tensors on the
model's device (``cuda`` unless asked for ``cpu``) and the gradient comes
from autograd where the reference uses ``jax.value_and_grad``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


def svm_objective(w, b, x, y, lam: float):
    margin = 1.0 - y * (x @ w + b)
    hinge = torch.clamp(margin, min=0.0)
    return 0.5 * lam * torch.sum(w * w) + torch.mean(hinge * hinge)


@dataclass
class LinearSVM:
    dim: int
    lam: float = 1e-4
    lr: float = 0.05
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.w = torch.zeros(self.dim, dtype=torch.float32, device=self.device)
        self.b = torch.zeros((), dtype=torch.float32, device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def train_batch(self, x: np.ndarray, y: np.ndarray, inner_steps: int = 1):
        x, y = self._tensor(x), self._tensor(y)
        w, b = self.w, self.b
        for _ in range(inner_steps):
            w = w.detach().requires_grad_(True)
            b = b.detach().requires_grad_(True)
            loss = svm_objective(w, b, x, y, self.lam)
            gw, gb = torch.autograd.grad(loss, (w, b))
            w, b = w.detach() - self.lr * gw, b.detach() - self.lr * gb
        self.w, self.b = w, b
        return float(loss.detach())

    @torch.no_grad()
    def objective(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(svm_objective(self.w, self.b, self._tensor(x),
                                   self._tensor(y), self.lam))

    @torch.no_grad()
    def accuracy(self, x: np.ndarray, y: np.ndarray) -> float:
        pred = np.sign((self._tensor(x) @ self.w + self.b).cpu().numpy())
        pred[pred == 0] = 1
        return float((pred == y).mean())


def relative_fdiff(f: float, f_star: float) -> float:
    return (f - f_star) / abs(f_star)
