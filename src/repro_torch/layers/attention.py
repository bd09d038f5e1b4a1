"""Grouped-query attention: projections, full causal prefill attention,
single-token decode attention (a whole cache or a sliding-window ring),
and the training path's attention.

Shapes follow the JAX package: q (B,S,H,D); k/v (B,T,K,D); H = K·G.
``full_attention``, ``decode_attention`` and ``decode_local_attention``
dispatch to the port's kernels (:mod:`repro_torch.kernels.ops`): the
CUDA kernels for tensors on the card, their plain versions for tensors on
the CPU.  They have no backward.  Training differentiates
``causal_attention``, ``local_attention`` and ``blocked_attention``,
plain torch products as the JAX package's training path computes them in
jnp outside any Pallas kernel, on the masked ``sdpa`` of
:mod:`repro_torch.layers.sdpa`; with ``ckpt`` their work between the
products is a remat segment (``common.segment``).  On the card,
``causal_attention`` in bf16 at head dim 64 or 128 runs the training
kernels instead (``ops.CausalAttention``).  On DTensors they run on each
rank's shards of rows and heads (``_per_head``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.layers.common import cast, dense_init, flatten, segment, unflatten
from repro_torch.layers.sdpa import NEG_INF, _expand_kv, softmax_weights
from repro_torch.layers.sdpa import sdpa as _sdpa


def _head_layout(mesh, q, k, v, *rest):
    """An attention whose rows and heads are independent, on each rank's
    local shards (as the kernels run): the batch split over the data
    dims, the heads over ``model`` where they divide it, the sequence
    whole.  Where q's heads divide ``model`` and k/v's do not, k and v are
    first expanded to q's heads (as ``sdpa`` expands them), so that every
    shard holds its heads' own keys.  DTensor's own propagation through
    the products' flattening has no rule for some of those splits (torch
    2.11: a flatten of two split dims)."""
    h, kh = q.shape[2], k.shape[2]
    if h != kh and ops._kernel_placements(mesh, 1, 2, (h,)) != \
            ops._kernel_placements(mesh, 1, 2, (h, kh)):
        b, t, _, d = k.shape
        k, v = (x[:, :, :, None].expand(b, t, kh, h // kh, d).reshape(b, t, h, d)
                for x in (k, v))
    pl = ops._kernel_placements(mesh, q.shape[0], 2, (q.shape[2], k.shape[2]))
    return pl, (pl, pl, pl), None, (q, k, v, *rest)


_per_head = ops.local_shards(_head_layout)


sdpa = _per_head(_sdpa)


def init_attn(generator, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, dtype, device):
    return {
        "wq": dense_init((d_model, num_heads, head_dim), dtype, generator, device),
        "wk": dense_init((d_model, num_kv_heads, head_dim), dtype, generator, device),
        "wv": dense_init((d_model, num_kv_heads, head_dim), dtype, generator, device),
        "wo": dense_init((num_heads, head_dim, d_model), dtype, generator, device),
    }


def project(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return unflatten(x @ cast(w.reshape(d, h * k), dtype), -1, (h, k))


def qkv(params, x: torch.Tensor, dtype):
    return (
        project(x, params["wq"], dtype),
        project(x, params["wk"], dtype),
        project(x, params["wv"], dtype),
    )


def out_proj(params, o: torch.Tensor, dtype) -> torch.Tensor:
    """einsum('bshk,hkd->bsd')."""
    h, k, d = params["wo"].shape
    return flatten(o, -2, -1) @ cast(params["wo"].reshape(h * k, d), dtype)


def full_attention(q, k, v, causal: bool = True):
    return ops.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, cur_index):
    """q: (B,1,H,D); caches: (B,T,K,D); attends to positions <= cur_index."""
    return ops.flash_decode(q[:, 0], k_cache, v_cache, cur_index)[:, None]


def decode_local_attention(q, k_ring, v_ring, cur_index, window: int):
    """Ring-buffer sliding-window decode: slot = position % T, the ring's
    T = min(window, capacity or prompt) <= window slots.  JAX masks slot
    s by ``pos(s) >= 0 and cur - pos(s) < window``, with ``pos(s) = cur -
    (cur - s) % T``; since ``cur - pos(s) < T <= window`` that keeps
    exactly the slots ``<= min(cur, T - 1)``, which is ``flash_decode``'s
    contract (``cur >= T`` attends the whole ring)."""
    if k_ring.shape[1] > window:
        raise ValueError(f"decode_local_attention: a ring of {k_ring.shape[1]} slots "
                         f"exceeds the window {window}")
    return decode_attention(q, k_ring, v_ring, cur_index)


def causal_mask(s: int, t=None, offset: int = 0, device=None) -> torch.Tensor:
    """(1,1,S,T) bool, True where key position <= query position."""
    t = t if t is not None else s
    qpos = offset + torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    return (kpos <= qpos)[None, None]


@_per_head
def causal_attention(q, k, v, ckpt: bool = False):
    """Causal attention, differentiable: the training path of the ``attn``
    kind.  Where ``ops.train_attention_route`` says ``"fused"`` (bf16 on
    the card, head dim 64 or 128, a group dividing 64) it is
    ``ops.CausalAttention``: the fused forward with its log-sum-exp and
    the fused backward, which save q, k, v, o and lse, so ``ckpt`` has
    nothing left to recompute in it (JAX's ``checkpoint_dots`` is matched
    in what it computes, not in what it keeps).  Everything else, the CPU
    and the meta device included, runs the masked ``sdpa``."""
    if ops.train_attention_route(q, k, v) == "fused":
        return ops.CausalAttention.apply(q, k, v)
    return sdpa(q, k, v, mask=causal_mask(q.shape[1], k.shape[1], device=q.device), ckpt=ckpt)


def blocked_applies(s: int, block: int) -> bool:
    """Whether JAX's ``blocked_attention`` takes its blocked branch for a
    sequence of ``s``; else it returns ``full_attention``'s result."""
    return s % block == 0 and s > block


def _online_step(sc, m, l, diag, scale: float, dtype):
    """One key block of the online softmax: the block's weights ``p`` in
    ``dtype``, the new running max and sum, and the accumulator's
    rescale."""
    sc = sc.float() * scale
    if diag is not None:
        sc = torch.where(diag, sc, NEG_INF)
    m_new = torch.maximum(m, sc.amax(-1))
    p = torch.exp(sc - m_new[..., None])
    corr = torch.exp(m - m_new)
    return p.to(dtype), m_new, l * corr + p.sum(-1), corr


def _rescale(acc, corr, pv):
    return acc * corr[..., None] + pv.float()


def _normalise(acc, l, dtype):
    return (acc / l.clamp(min=1e-30)[..., None]).to(dtype)


@_per_head
def blocked_attention(q, k, v, block: int = 1024, ckpt: bool = False):
    """Flash-style causal attention as the JAX package computes it: per
    query block, an online softmax over key blocks (scores in the input
    dtype, then f32 times 1/sqrt(D); p cast to q's dtype before P·V; the
    f32 accumulator rescaled at each block).  Key blocks past the query
    block's diagonal are skipped: JAX visits them, but there every key is
    masked, so they add exactly 0 and rescale by exactly 1.  Where
    ``blocked_applies`` is false, the masked ``causal_attention``."""
    b, s, h, d = q.shape
    if not blocked_applies(s, block):
        return causal_attention(q, k, v, ckpt)
    k, v = _expand_kv(q, k, v)
    scale = 1.0 / math.sqrt(d)
    pos = torch.arange(block, device=q.device)
    diag = (pos[None, :] <= pos[:, None])[None, None]  # the diagonal block: key <= query
    outs = []
    for i in range(s // block):
        qi = q[:, i * block:(i + 1) * block]
        m = torch.full((b, h, block), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, block, d), dtype=torch.float32, device=q.device)
        for j in range(i + 1):
            kj, vj = k[:, j * block:(j + 1) * block], v[:, j * block:(j + 1) * block]
            sc = torch.einsum("bshd,bthd->bhst", qi, kj)
            p, m, l, corr = segment(ckpt, _online_step, sc, m, l, diag if j == i else None,
                                    scale, q.dtype)
            acc = segment(ckpt, _rescale, acc, corr, torch.einsum("bhst,bthd->bhsd", p, vj))
        o = segment(ckpt, _normalise, acc, l, q.dtype)
        outs.append(o.transpose(1, 2))  # (b, block, h, d)
    return torch.cat(outs, dim=1)


@_per_head
def local_attention(q, k, v, window: int, ckpt: bool = False):
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
        return sdpa(q, k, v, mask=mask, ckpt=ckpt)
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
    scores = torch.einsum("bnchd,bnthd->bnhct", qc, kk)
    qpos = torch.arange(c, device=dev)[:, None] + c
    kpos = torch.arange(2 * c, device=dev)[None, :]
    delta = qpos - kpos
    mask = (delta >= 0) & (delta < window)  # (c, 2c)
    first = kpos >= c  # chunk 0: the previous chunk is padding
    nmask = torch.cat([(mask & first)[None], mask[None].expand(n - 1, c, 2 * c)], dim=0)
    w = segment(ckpt, softmax_weights, scores, nmask[None, :, None], d, q.dtype)
    o = torch.einsum("bnhct,bnthd->bnchd", w, vv)
    return o.reshape(b, s, h, d)
