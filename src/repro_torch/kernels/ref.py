"""Plain-PyTorch versions of the kernels on the serving path.

They follow the layer functions the JAX serve path calls, rounding where
those round: ``sdpa`` / ``full_attention`` (``layers/attention.py``,
scores taken in the input dtype then f32, softmax weights cast to q's
dtype before P·V) and ``decode_attention`` / ``_grouped_sdpa`` (grouped
caches, mask ``position <= cur``).  The CUDA kernels keep p unnormalised
and divide at the end, so in bf16 the two differ by rounding; the tests
and the smoke run hold them to 2e-5 in f32 and 2e-2 in bf16.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _expand_kv(q, k, v):
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return k, v


def sdpa(q, k, v, mask=None):
    """Expanded-head attention.  mask broadcastable to (B,H,S,T), True=keep."""
    d = q.shape[-1]
    k, v = _expand_kv(q, k, v)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(d)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def causal_mask(s: int, t: int, device) -> torch.Tensor:
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    return (kpos <= qpos)[None, None]  # (1,1,S,T)


def flash_attention(q, k, v, causal: bool = True):
    """q: (B,S,H,D); k, v: (B,T,K,D).  Returns (B,S,H,D)."""
    mask = causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    return sdpa(q, k, v, mask=mask)


def _grouped_sdpa(q, k, v, mask):
    """Grouped path: caches stay at K heads.  mask broadcastable to
    (B,K,G,S,T)."""
    b, s, h, d = q.shape
    kheads = k.shape[2]
    qg = q.reshape(b, s, kheads, h // kheads, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(d)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v)
    return o.reshape(b, s, h, d)


def flash_decode(q, k_cache, v_cache, cur_index):
    """q: (B,H,D); caches: (B,T,K,D); attends to positions <= cur_index[b]
    (every position when cur_index[b] >= T).  Returns (B,H,D)."""
    t = k_cache.shape[1]
    cur = cur_index.reshape(-1, 1)
    pos = torch.arange(t, device=q.device)[None, :]
    mask = (pos <= cur)[:, None, None, None, :]  # (B,1,1,1,T)
    return _grouped_sdpa(q[:, None], k_cache, v_cache, mask)[:, 0]
