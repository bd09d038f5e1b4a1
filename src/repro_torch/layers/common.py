"""Shared primitives: init, norms, activations, the remat segment and
the weight cast that ``remat="dots"`` recasts in the backward."""
from __future__ import annotations

import contextlib
import math
import threading
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


_LOCAL = threading.local()  # .casts: the registry of recast_weights, or None


def cast(w: torch.Tensor, dtype) -> torch.Tensor:
    """``w.to(dtype)``: a weight cast at its use.  Inside
    ``recast_weights`` the cast is registered, so that autograd saves the
    weight it came from in its place."""
    c = w.to(dtype)
    casts = getattr(_LOCAL, "casts", None)
    if casts is not None and c is not w and c.numel():
        casts[c.untyped_storage().data_ptr()] = (c, _Recast(w, dtype))
    return c


class _Recast:
    """One weight cast as the backward gets it back: cast again from the
    weight.  The recast is kept while saved views of it are still to be
    unpacked (a ragged product saves a view per expert)."""

    def __init__(self, w: torch.Tensor, dtype):
        self.w, self.dtype, self.pending, self.cast = w, dtype, 0, None

    def unpack(self) -> torch.Tensor:
        c = self.cast if self.cast is not None else self.w.detach().to(self.dtype)
        self.pending -= 1
        self.cast = c if self.pending > 0 else None
        return c


@contextlib.contextmanager
def recast_weights():
    """Autograd saves no weight cast made by ``cast`` in this scope (a
    pattern period under ``remat="dots"``): a saved tensor that lies in a
    registered cast's storage (the cast or a view of it) is saved as its
    weight, dtype, size, stride and offset, and the backward casts the
    weight again, as JAX's ``checkpoint_dots`` recomputes the casts.
    Recasting gives the same bits, so values do not change."""
    casts = {}

    def pack(t):
        hit = casts.get(t.untyped_storage().data_ptr())
        if hit is None:
            return t
        hit[1].pending += 1
        return hit[1], t.size(), t.stride(), t.storage_offset()

    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        recast, size, stride, offset = packed
        return recast.unpack().as_strided(size, stride, offset)

    outer, _LOCAL.casts = getattr(_LOCAL, "casts", None), casts
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _LOCAL.casts = outer
        # every tensor saved in the scope keeps ``pack`` (and so this
        # registry) until the backward: drop the casts now
        casts.clear()
