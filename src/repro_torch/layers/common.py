"""Shared primitives: init, norms, activations, and the remat segment."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(
    shape: Sequence[int],
    dtype: torch.dtype,
    generator: torch.Generator,
    device,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-ish): a standard normal cut to
    [-2, 2], times ``1/sqrt(shape[0])`` unless ``scale`` is given."""
    shape = tuple(shape)
    if scale is None:
        fan_in = shape[0] if len(shape) >= 2 else max(1, shape[-1])
        scale = 1.0 / math.sqrt(fan_in)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def activation_fn(name: str):
    if name in ("gelu", "geglu"):
        return _gelu
    if name in ("swiglu", "silu"):
        return F.silu
    raise ValueError(name)


def segment(ckpt: bool, fn, *xs):
    """``fn(*xs)``: a stretch of a block's work between two matrix
    products.  With ``ckpt`` (``remat="dots"`` in training) it runs under
    ``checkpoint``: the backward recomputes it from its inputs, which are
    the products' outputs, and the products outside every segment keep
    their own inputs, so no product is recomputed (JAX's
    ``checkpoint_dots``).  The forward draws no random numbers."""
    if ckpt:
        return checkpoint(fn, *xs, use_reentrant=False, preserve_rng_state=False)
    return fn(*xs)
