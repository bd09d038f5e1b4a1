"""Positional encodings: RoPE, M-RoPE (Qwen2-VL), sinusoidal."""
from __future__ import annotations

import functools
from typing import Tuple

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


@functools.lru_cache(maxsize=None)
def _band_streams(sections: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """(half,) int64: which position stream (0 temporal, 1 height, 2
    width) drives each frequency band, built once in numpy."""
    sel = np.concatenate([np.full((s,), i, dtype=np.int64) for i, s in enumerate(sections)])
    return torch.as_tensor(sel, device=device)


def mrope_angles(positions_3d: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...]) -> torch.Tensor:
    """M-RoPE: the frequency bands are split across the (temporal, height,
    width) position streams.  positions_3d: (B, 3, S) int -> angles (B, S,
    head_dim//2) f32; ``sections`` sum to head_dim//2."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim/2 = {half}")
    dev = positions_3d.device
    pos = positions_3d.float().index_select(1, _band_streams(tuple(sections), dev))  # (B,half,S)
    return pos.transpose(1, 2) * _inv_freq(head_dim, theta, dev)


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


@functools.lru_cache(maxsize=None)
def sinusoidal(length: int, dim: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(length, dim) sinusoidal position table: built in numpy f32 as the
    JAX package builds it, cast to ``dtype`` and uploaded once per
    (length, dim, dtype, device).  Callers must not write to it."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    i = np.arange(dim // 2, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.as_tensor(emb).to(device=device, dtype=dtype)


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


def vl_positions(n: int, text: int, grid: Tuple[int, int], device=None) -> torch.Tensor:
    """(3, n) int32 M-RoPE positions (temporal, height, width) of one
    prompt laid out as Qwen2-VL lays one out (arXiv:2409.12191, §2.1):
    ``text`` text tokens at t = h = w = their index, an image of ``grid``
    (h, w) patches (cut off at ``n``) whose t stays at the image's start
    while h and w walk the grid, then text resuming at the image's
    largest position + 1.  Stack rows for a batch's ``positions_3d``."""
    hh, ww = grid
    idx = torch.arange(n)
    img = idx - text
    in_img = (img >= 0) & (img < hh * ww)
    after = idx - hh * ww + max(hh, ww)  # text after the image: its max + 1 onwards
    base = torch.where(idx < text, idx, after)
    t = torch.where(in_img, torch.full_like(idx, text), base)
    h = torch.where(in_img, text + img.clamp(min=0) // ww, base)
    w = torch.where(in_img, text + img.clamp(min=0) % ww, base)
    return torch.stack([t, h, w]).to(device, torch.int32)
