"""Block-level init/apply dispatch (the ``attn`` kind).

A *block* is one residual unit of a stage pattern.  The port runs the
``attn`` kind in the two modes the serving engine uses:
    prefill  — full sequence, emits a decode cache
    decode   — one token per row at per-row positions (continuous
               batching), consumes and updates its cache in place
Other kinds, training mode and scalar-position decode are refused.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.layers import attention as attn
from repro_torch.layers.common import rms_norm
from repro_torch.layers.mlp import apply_ffn, init_ffn
from repro_torch.layers.positional import apply_rope
from repro_torch.models.config import ModelConfig

PORTED_KINDS = ("attn",)


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; repro_torch runs "
            f"{PORTED_KINDS} blocks"
        )


def init_block(generator, kind: str, cfg: ModelConfig, device):
    _check_kind(kind)
    dt = cfg.store_dtype
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.kq_dim
    return {
        "norm1": torch.zeros((d,), dtype=dt, device=device),
        "attn": attn.init_attn(generator, d, h, kv, hd, dt, device),
        "norm2": torch.zeros((d,), dtype=dt, device=device),
        "ffn": init_ffn(generator, d, cfg.d_ff, cfg.activation, dt, device),
    }


def init_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int, device):
    """Zeroed per-block decode cache in the compute dtype."""
    _check_kind(kind)
    shape = (batch, capacity, cfg.num_kv_heads, cfg.kq_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
    }


def _self_attention(p, x, cfg: ModelConfig, mode: str, cache, pos, aux):
    dt = cfg.compute_dtype
    q, k, v = attn.qkv(p["attn"], x, dt)
    angles = aux.get("rope_angles")
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    if mode == "prefill":
        if cfg.attn_impl != "full":
            raise NotImplementedError(f"attn_impl {cfg.attn_impl!r} is not ported yet")
        o = attn.full_attention(q, k, v, causal=True)
        return attn.out_proj(p["attn"], o, dt), {"k": k, "v": v}
    if mode != "decode":
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    if pos is None or pos.dim() != 1:
        raise NotImplementedError("decode takes per-row positions pos (B,)")
    # per-slot decode: row i writes its token at pos[i], clamped to the
    # last slot as jax.lax.dynamic_update_slice clamps (idle slots keep
    # advancing past the arena's end), then attends positions <= pos[i].
    # The write updates the cache in place.
    ck, cv = cache["k"], cache["v"]
    rows = torch.arange(x.shape[0], device=x.device)
    idx = pos.clamp(max=ck.shape[1] - 1).long()
    ck[rows, idx] = k[:, 0]
    cv[rows, idx] = v[:, 0]
    o = attn.decode_attention(q, ck, cv, pos.to(torch.int32))
    return attn.out_proj(p["attn"], o, dt), cache


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
    """Returns ``(x, cache)``."""
    _check_kind(kind)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    o, new_cache = _self_attention(p, h, cfg, mode, cache, pos, aux or {})
    x = x + o
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    y = apply_ffn(p["ffn"], h2, cfg.activation, cfg.compute_dtype)
    return x + y, new_cache
