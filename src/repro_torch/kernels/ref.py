"""Plain-PyTorch versions of the port's kernels.

``batch_gather`` (the DNN path's LIRS gather) copies bytes, so the
kernels are bit-exact against it; it follows ``batch_gather_ref`` and
normalises out-of-range block ids as the JAX gathers do.

``csr_dot`` (the sparse-SVM path) sums in the CUDA kernel's order — the
products, then the K/32 lane-strided slices left to right, then the 32
partials folded in halves — so the kernel is bit-exact against it.

The attention functions (the serving path) follow the layer functions the JAX serve path calls, rounding where
those round: ``sdpa`` / ``full_attention`` (``layers/attention.py``,
scores taken in the input dtype then f32, softmax weights cast to q's
dtype before P·V) and ``decode_attention`` / ``_grouped_sdpa`` (grouped
caches, mask ``position <= cur``).  The CUDA kernels keep p unnormalised
and divide at the end, so in bf16 the two differ by rounding; the tests
and the smoke run hold them to 2e-5 in f32 and 2e-2 in bf16.  ``sdpa``
is the port's layer function (:mod:`repro_torch.layers.sdpa`), which the
training path differentiates too.

``rglru_scan`` / ``rglru_scan_bwd`` (the RG-LRU layer's recurrence and
its gradient, the training path) walk time one step at a time, each step
one multiply and then one add in f32, as csrc/rglru_scan.cu does: the
kernel is bit-exact against them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.layers.sdpa import NEG_INF, sdpa


def batch_gather(table, indices, rows_per_block: int = 1):
    """table (N, D), indices (B,) block ids → (B·r, D): block i is rows
    ``idx·r .. idx·r + r − 1`` of the table, ``r = rows_per_block``.  As
    in ``batch_gather_ref`` (and the Pallas kernels, which read through
    clamped slices), a negative id has ``N / r`` added once and the id is
    then clamped to ``[0, N / r − 1]``; plain torch indexing would raise."""
    n, d = table.shape
    r = rows_per_block
    nb = n // r
    i = indices.to(torch.int32).long()
    i = torch.where(i < 0, i + nb, i).clamp(0, nb - 1)
    return table.reshape(nb, r, d)[i].reshape(indices.shape[0] * r, d)


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


def csr_dot(indices, values, w):
    """indices (B,K) int, values (B,K), w (D,): ``out[b] = Σ_k
    values[b,k]·w[indices[b,k]]`` in f32, summed as csrc/csr_dot.cu sums:
    lane l of a warp adds products l, l+32, ... left to right from 0.0,
    then the 32 lane sums fold in halves (16, 8, 4, 2, 1)."""
    prod = values.float() * w.float()[indices.long()]
    b, k = prod.shape
    slices = -(-k // 32)
    prod = F.pad(prod, (0, 32 * slices - k)).reshape(b, slices, 32)
    acc = prod.new_zeros(b, 32)
    for s in range(slices):
        acc = acc + prod[:, s]
    width = 16
    while width:
        acc = acc[:, :width] + acc[:, width:]
        width //= 2
    return acc[:, 0]


def rglru_scan(a, x):
    """a, x: (B,T,W) -> h (B,T,W) f32 with ``h_t = a_t·h_{t-1} + x_t`` and
    ``h_{-1} = 0`` (``rglru_scan_ref``), stepped through time in order."""
    a, x = a.float(), x.float()
    h = torch.empty_like(x)
    carry = x.new_zeros(x.shape[0], x.shape[2])
    for t in range(x.shape[1]):
        carry = a[:, t] * carry + x[:, t]
        h[:, t] = carry
    return h


def rglru_scan_bwd(a, h, dh):
    """The scan's gradient from the saved ``a`` and ``h`` (B,T,W): walking
    from the last step, ``g_t = dh_t + a_{t+1}·g_{t+1}`` (``g_{T-1} =
    dh_{T-1}``), ``dx_t = g_t`` and ``da_t = g_t·h_{t-1}`` (``h_{-1} = 0``).
    Returns ``(dx, da)`` in f32."""
    a, h, dh = a.float(), h.float(), dh.float()
    dx, da = torch.empty_like(dh), torch.empty_like(dh)
    g = dh.new_zeros(dh.shape[0], dh.shape[2])
    a_next = torch.zeros_like(g)
    zero = torch.zeros_like(g)
    for t in reversed(range(dh.shape[1])):
        g = dh[:, t] + a_next * g
        dx[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t else zero)
        a_next = a[:, t]
    return dx, da
