"""AdamW written out (no ``torch.optim``), the JAX package's optimizer.

When model params are stored in bf16 (``param_dtype='bfloat16'``), the
optimizer keeps an f32 master copy in its state; with f32 params it is a
standard AdamW.  Global-norm clipping in f32, bias correction from the new
step count, the learning rate of the old count (warmup, then optional
cosine decay), weight decay on every leaf.

The JAX step donates its state and returns a new one; this update writes
the new values into the state's and the parameters' tensors, leaf by
leaf, so its temporaries are one leaf's, not a tree's (each whole-model
f32 tree is 10 GiB at recurrentgemma-2b's size).  The scalars (count,
learning rate, clip scale, bias corrections) stay on the device: an
update never waits for it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # cosine decay horizon; 0 -> constant lr after warmup
    decay_steps: int = 0
    min_lr_frac: float = 0.1


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class AdamW:
    def __init__(self, cfg: AdamWConfig = AdamWConfig()):
        self.cfg = cfg

    def init(self, params):
        leaves = tree_leaves(params)
        state = {
            "mu": tree_map(_f32_zeros, params),
            "nu": tree_map(_f32_zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        }
        if any(p.dtype == torch.bfloat16 for p in leaves):
            state["master"] = tree_map(lambda p: p.float().clone(), params)
        return state

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (a 0-d tensor), as a 0-d f32 tensor."""
        c = self.cfg
        step = step.float()
        warm = torch.clamp((step + 1.0) / max(1, c.warmup_steps), max=1.0)
        if c.decay_steps:
            t = torch.clamp((step - c.warmup_steps) / max(1, c.decay_steps), 0.0, 1.0)
            cos = 0.5 * (1.0 + torch.cos(math.pi * t))
            frac = c.min_lr_frac + (1.0 - c.min_lr_frac) * cos
        else:
            frac = 1.0
        return c.lr * warm * frac

    @torch.no_grad()
    def update(self, grads, state, params):
        """One AdamW step, in place: ``params`` and ``state`` hold the new
        values after it (``state["count"]`` advanced by one).  ``grads``
        has the tree of ``params`` and is consumed (f32 gradients are scaled
        in place).  Returns ``{"grad_norm", "lr"}``, 0-d device tensors."""
        c = self.cfg
        lr = self.lr_at(state["count"])
        state["count"].add_(1)
        cf = state["count"].float()
        bc1 = 1.0 - torch.pow(c.b1, cf)
        bc2 = 1.0 - torch.pow(c.b2, cf)

        gs = tree_leaves(grads)
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in gs))
        scale = torch.where(
            gnorm > c.grad_clip, c.grad_clip / torch.clamp(gnorm, min=1e-12), 1.0
        )
        ps = tree_leaves(params)
        masters = tree_leaves(state["master"]) if "master" in state else ps
        for p, m32, g, mu, nu in zip(ps, masters, gs, tree_leaves(state["mu"]),
                                     tree_leaves(state["nu"])):
            g = g.float()  # a bf16 leaf's f32 copy, one leaf at a time
            g.mul_(scale)
            mu.mul_(c.b1).add_(g, alpha=1 - c.b1)
            nu.mul_(c.b2).add_(g.square_(), alpha=1 - c.b2)
            step = (mu / bc1).div_((nu / bc2).sqrt_().add_(c.eps))
            step.add_(m32, alpha=c.weight_decay).mul_(lr)
            m32.sub_(step)
            if p is not m32:
                p.copy_(m32)
        return {"grad_norm": gnorm, "lr": lr}
