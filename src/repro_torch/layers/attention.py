"""Grouped-query attention: projections, full causal prefill attention,
single-token decode attention, and the training path's attention.

Shapes follow the JAX package: q (B,S,H,D); k/v (B,T,K,D); H = K·G.
``full_attention`` and ``decode_attention`` dispatch to the port's
kernels (:mod:`repro_torch.kernels.ops`): the CUDA kernels for tensors on
the card, their plain versions for tensors on the CPU.  They have no
backward.  Training differentiates ``causal_attention`` and
``local_attention``, plain torch products as the JAX package's training
path computes them in jnp outside any Pallas kernel, on the masked
``sdpa`` of :mod:`repro_torch.layers.sdpa`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.layers.common import dense_init
from repro_torch.layers.sdpa import NEG_INF, _expand_kv, sdpa


def init_attn(generator, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, dtype, device):
    return {
        "wq": dense_init((d_model, num_heads, head_dim), dtype, generator, device),
        "wk": dense_init((d_model, num_kv_heads, head_dim), dtype, generator, device),
        "wv": dense_init((d_model, num_kv_heads, head_dim), dtype, generator, device),
        "wo": dense_init((num_heads, head_dim, d_model), dtype, generator, device),
    }


def _project(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(dtype)).unflatten(-1, (h, k))


def qkv(params, x: torch.Tensor, dtype):
    return (
        _project(x, params["wq"], dtype),
        _project(x, params["wk"], dtype),
        _project(x, params["wv"], dtype),
    )


def out_proj(params, o: torch.Tensor, dtype) -> torch.Tensor:
    """einsum('bshk,hkd->bsd')."""
    h, k, d = params["wo"].shape
    return o.flatten(-2) @ params["wo"].reshape(h * k, d).to(dtype)


def full_attention(q, k, v, causal: bool = True):
    return ops.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, cur_index):
    """q: (B,1,H,D); caches: (B,T,K,D); attends to positions <= cur_index."""
    return ops.flash_decode(q[:, 0], k_cache, v_cache, cur_index)[:, None]


def causal_mask(s: int, t=None, offset: int = 0, device=None) -> torch.Tensor:
    """(1,1,S,T) bool, True where key position <= query position."""
    t = t if t is not None else s
    qpos = offset + torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    return (kpos <= qpos)[None, None]


def causal_attention(q, k, v):
    """Causal attention through the masked ``sdpa`` (differentiable; the
    training path of the ``attn`` kind)."""
    return sdpa(q, k, v, mask=causal_mask(q.shape[1], k.shape[1], device=q.device))


def local_attention(q, k, v, window: int):
    """Chunked sliding-window attention: O(S·w) instead of O(S²).  Up to
    ``window`` positions it is the masked ``sdpa``; past that, S must be a
    multiple of the window and each chunk attends to itself and the chunk
    before it (chunk 0's predecessor is padding, masked out)."""
    b, s, h, d = q.shape
    k, v = _expand_kv(q, k, v)
    dev = q.device
    if s <= window:
        pos = torch.arange(s, device=dev)
        mask = causal_mask(s, device=dev) & (pos[:, None] - pos[None, :] < window)[None, None]
        return sdpa(q, k, v, mask=mask)
    c = window
    assert s % c == 0, f"seq {s} must be a multiple of window {c}"
    n = s // c
    qc = q.reshape(b, n, c, h, d)
    kc = k.reshape(b, n, c, h, d)
    vc = v.reshape(b, n, c, h, d)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kk = torch.cat([kprev, kc], dim=2)  # (B,n,2c,H,D)
    vv = torch.cat([vprev, vc], dim=2)
    scores = torch.einsum("bnchd,bnthd->bnhct", qc, kk).float() / math.sqrt(d)
    qpos = torch.arange(c, device=dev)[:, None] + c
    kpos = torch.arange(2 * c, device=dev)[None, :]
    delta = qpos - kpos
    mask = (delta >= 0) & (delta < window)  # (c, 2c)
    first = kpos >= c  # chunk 0: the previous chunk is padding
    nmask = torch.cat([(mask & first)[None], mask[None].expand(n - 1, c, 2 * c)], dim=0)
    scores = torch.where(nmask[None, :, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bnhct,bnthd->bnchd", w, vv)
    return o.reshape(b, s, h, d)
