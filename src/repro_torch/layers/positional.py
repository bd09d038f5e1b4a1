"""Positional encodings: RoPE."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The RoPE inverse frequencies, computed in numpy as the JAX package
    does and uploaded once per device (an upload per call would make
    every forward wait on the device)."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.as_tensor(inv_freq, device=device)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions: (..., S) int -> angles (..., S, head_dim//2) f32."""
    return positions.float()[..., None] * _inv_freq(head_dim, theta, positions.device)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (S, D/2) or (B, S, D/2).  Rotates in f32
    and casts back to x's dtype."""
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]  # (B,S,1,D/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def default_positions(batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """(batch, seq) int32 positions ``offset + arange(seq)``; ``offset``
    is an int, a 0-d tensor (scalar-position decode: read on the device,
    no wait for it) or a (batch,) tensor of per-row offsets
    (continuous-batching decode)."""
    base = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, torch.Tensor):
        off = offset.to(torch.int32)
        return (off[:, None] if off.dim() else off) + base.expand(batch, seq)
    return (base + int(offset)).expand(batch, seq)
