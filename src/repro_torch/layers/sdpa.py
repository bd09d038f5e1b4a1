"""Masked expanded-head attention in plain torch products, as the JAX
package's ``layers/attention.py`` computes it in jnp: scores in the input
dtype, then f32 scaled by 1/sqrt(D); softmax in f32; weights cast to q's
dtype before P·V.

The training path's attention differentiates through it, and the
attention kernels' plain versions (``kernels/ref.py``) are built on it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _expand_kv(q, k, v):
    """Repeat each of K kv heads H/K times to match q's H heads."""
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
