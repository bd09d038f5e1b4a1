"""Block-level init/apply dispatch.

A *block* is one residual unit of a stage pattern.  The port runs the
``attn``, ``local_attn``, ``rglru`` and ``moe`` kinds in the JAX
package's three modes:
    train    full sequence, no cache
    prefill  full sequence, emits a decode cache
    decode   one token, updates its cache in place and returns it
Blocks return ``(x, cache, aux)``, ``aux`` the MoE load-balancing loss of
a ``moe`` block (an f32 scalar) and ``0.0`` for the other kinds.  A
``moe`` block is an ``attn`` block whose FFN is ``layers/moe.py``'s.
Decode (``M.decode_step``) takes one scalar position for the batch, or,
for ``attn`` and ``moe`` blocks, one position per row (continuous
batching, the JAX package's ``M.decode_step_slots``); both write and
attend through one path.  Per-row positions with a ``local_attn`` block
are refused: the JAX package cannot run them either (its ring write is a
``dynamic_update_slice`` at a scalar slot).  Other kinds are refused.

In training, ``aux["remat_segments"]`` (``remat="dots"``) runs each
block's work between its matrix products in remat segments
(``common.segment``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.layers import attention as attn
from repro_torch.layers import moe as moe_lib
from repro_torch.layers import rglru as rglru_lib
from repro_torch.layers.common import rms_norm, segment
from repro_torch.layers.mlp import apply_ffn, init_ffn
from repro_torch.layers.positional import apply_rope
from repro_torch.models.config import ModelConfig

PORTED_KINDS = ("attn", "local_attn", "rglru", "moe")
ATTN_IMPLS = ("full", "blocked")


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; repro_torch runs {PORTED_KINDS} blocks"
        )


def init_block(generator, kind: str, cfg: ModelConfig, device):
    _check_kind(kind)
    dt = cfg.store_dtype
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.kq_dim
    p: Dict[str, Any] = {"norm1": torch.zeros((d,), dtype=dt, device=device)}
    if kind == "rglru":
        p["rglru"] = rglru_lib.init_rglru(generator, d, cfg.rnn_width or d, cfg.conv_width,
                                          dt, device, cfg.num_heads)
    else:
        p["attn"] = attn.init_attn(generator, d, h, kv, hd, dt, device)
    p["norm2"] = torch.zeros((d,), dtype=dt, device=device)
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(generator, cfg, cfg.moe, dt, device)
    else:
        p["ffn"] = init_ffn(generator, d, cfg.d_ff, cfg.activation, dt, device)
    return p


def init_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int, device):
    """Zeroed per-block decode cache: K/V (B, C, K, D) for ``attn`` and ``moe``, a ring
    of ``min(window, C)`` slots for ``local_attn``, both in the compute
    dtype; for ``rglru`` the state ``h`` (B, W) in f32 and the conv
    history (B, CW-1, W) in the compute dtype."""
    _check_kind(kind)
    dt = cfg.compute_dtype
    if kind == "rglru":
        w = cfg.rnn_width or cfg.d_model
        return {
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dt, device=device),
        }
    if kind == "local_attn":
        capacity = min(cfg.local_window, capacity)
    shape = (batch, capacity, cfg.num_kv_heads, cfg.kq_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _causal(q, k, v, cfg: ModelConfig, mode: str, ckpt: bool):
    """The ``attn`` kind's causal attention in train and prefill: the
    blocked online softmax where ``attn_impl="blocked"`` takes its blocked
    branch; else the masked ``sdpa`` in training and the attention kernel
    (K4) in prefill, which has no backward."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {cfg.attn_impl!r}")
    if cfg.attn_impl == "blocked" and attn.blocked_applies(q.shape[1], cfg.attn_block):
        return attn.blocked_attention(q, k, v, cfg.attn_block, ckpt)
    if mode == "train":
        return attn.causal_attention(q, k, v, ckpt)
    return attn.full_attention(q, k, v, causal=True)


def _rope(q, k, angles):
    return apply_rope(q, angles), apply_rope(k, angles)


def _self_attention(p, x, cfg: ModelConfig, kind: str, mode: str, cache, pos, aux, ckpt):
    dt = cfg.compute_dtype
    q, k, v = attn.qkv(p["attn"], x, dt)
    angles = aux.get("rope_angles")
    if angles is not None:
        q, k = segment(ckpt, _rope, q, k, angles)
    if mode == "train":
        if kind == "local_attn":
            o = attn.local_attention(q, k, v, cfg.local_window, ckpt)
        else:
            o = _causal(q, k, v, cfg, mode, ckpt)
        return attn.out_proj(p["attn"], o, dt), None
    if mode == "prefill":
        if kind == "local_attn":
            # the ring keeps the last w positions at slot = pos % w
            s = k.shape[1]
            w = min(cfg.local_window, s)
            o = attn.local_attention(q, k, v, cfg.local_window)
            roll = (s - w) % w
            new = {"k": torch.roll(k[:, s - w:], roll, dims=1),
                   "v": torch.roll(v[:, s - w:], roll, dims=1)}
        else:
            o = _causal(q, k, v, cfg, mode, False)
            new = {"k": k, "v": v}
        return attn.out_proj(p["attn"], o, dt), new
    # decode: row i writes its token at cur[i] (a scalar pos is every row
    # at one position) and attends positions <= cur[i]; the write updates
    # the cache in place
    local = kind == "local_attn"
    if local and pos.dim() == 1:
        raise ValueError(
            "local_attn decode takes one scalar position for the batch: per-row "
            "positions would write each row's ring at its own slot, which the JAX "
            "package cannot run either (dynamic_update_slice at a scalar slot)")
    ck, cv = cache["k"], cache["v"]
    b, t = x.shape[0], ck.shape[1]
    cur = pos.to(torch.int32).expand(b).contiguous()
    # the ring writes at pos % t; the attn cache clamps to its last slot as
    # jax.lax.dynamic_update_slice clamps (idle serving slots keep advancing
    # past the arena's end)
    idx = (cur % t if local else cur.clamp(max=t - 1)).long()
    rows = torch.arange(b, device=x.device)
    ck[rows, idx] = k[:, 0]
    cv[rows, idx] = v[:, 0]
    if local:
        o = attn.decode_local_attention(q, ck, cv, cur, cfg.local_window)
    else:
        o = attn.decode_attention(q, ck, cv, cur)
    return attn.out_proj(p["attn"], o, dt), cache


def _rglru(p, x, cfg: ModelConfig, mode: str, cache, ckpt: bool):
    dt = cfg.compute_dtype
    if mode == "decode":
        o, (hs, hist) = rglru_lib.apply_rglru_step(p["rglru"], x, (cache["h"], cache["conv"]), dt)
        cache["h"].copy_(hs)  # in place, as the attention caches
        cache["conv"].copy_(hist)
        return o, cache
    o, (hs, hist) = rglru_lib.apply_rglru(p["rglru"], x, dt, ckpt=ckpt)
    return o, ({"h": hs, "conv": hist.to(dt)} if mode == "prefill" else None)


def apply_block(
    kind: str,
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    mode: str,
    cache=None,
    pos: Optional[torch.Tensor] = None,
    aux: Optional[Dict[str, Any]] = None,
):
    """Returns ``(x, cache, aux loss)``; the cache is None in train mode,
    the aux loss an f32 scalar for ``moe`` blocks and ``0.0`` for the
    others."""
    _check_kind(kind)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train|prefill|decode, got {mode!r}")
    aux = aux or {}
    ckpt = bool(aux.get("remat_segments"))
    dt = cfg.compute_dtype
    h = segment(ckpt, rms_norm, x, p["norm1"], cfg.norm_eps)
    if kind == "rglru":
        o, new_cache = _rglru(p, h, cfg, mode, cache, ckpt)
    else:
        o, new_cache = _self_attention(p, h, cfg, kind, mode, cache, pos, aux, ckpt)
    x = x + o
    h2 = segment(ckpt, rms_norm, x, p["norm2"], cfg.norm_eps)
    if kind == "moe":
        y, aloss = moe_lib.apply_moe(p["moe"], h2, cfg, cfg.moe, dt, ckpt)
        return x + y, new_cache, aloss
    return x + apply_ffn(p["ffn"], h2, cfg.activation, dt, ckpt), new_cache, 0.0
