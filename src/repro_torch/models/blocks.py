"""Block-level init/apply dispatch.

A *block* is one residual unit of a stage pattern.  The port runs every
kind of the JAX package (``attn``, ``local_attn``, ``rglru``, ``moe``,
``mlstm``, ``slstm``, ``enc_attn``, ``dec_attn``) in its three modes:
    train    full sequence, no cache
    prefill  full sequence, emits a decode cache
    decode   one token, updates its cache in place and returns it
Blocks return ``(x, cache, aux)``, ``aux`` the MoE load-balancing loss of
a ``moe`` block (an f32 scalar) and ``0.0`` for the other kinds.  A
``moe`` block is an ``attn`` block whose FFN is ``layers/moe.py``'s; an
``mlstm`` block is the mLSTM layer alone (no second norm, no FFN), an
``slstm`` block the sLSTM layer and a GeGLU FFN of ``_slstm_ff`` units.
An ``enc_attn`` block (the encoder's) is bidirectional attention and an
FFN, run in train and prefill only: the plain ``sdpa`` in training, the
attention kernel (K4) with ``causal=False`` in prefill.  A ``dec_attn``
block is the ``attn`` kind's causal self-attention, then cross-attention
from the decoder's queries to the encoder output's projections ``ck``/
``cv`` (no RoPE), then the FFN; prefill caches ``ck``/``cv`` beside
``k``/``v``, and decode reads them (K6 at ``cur = T - 1``: every frame)
and never writes them.
Decode (``M.decode_step``) takes one scalar position for the batch, or,
for ``attn``, ``moe`` and ``dec_attn`` blocks, one position per row
(continuous batching, the JAX package's ``M.decode_step_slots``); both
write and attend through one path.  Per-row positions with a
``local_attn`` block are refused: the JAX package cannot run them either
(its ring write is a ``dynamic_update_slice`` at a scalar slot).  An
unknown kind raises ``ValueError``, as in the JAX package.

In training, ``aux["remat_segments"]`` (``remat="dots"``) runs each
block's work between its matrix products in remat segments
(``common.segment``).

With a ``ctx`` (``common.ShardCtx``) holding a mesh, the residual after
the self-attention of the ``attn``, ``local_attn``, ``enc_attn`` and
``moe`` kinds is laid out as JAX constrains it: the batch over the data
dims, and in training with ``sequence_parallel`` the sequence over
``model`` (Megatron-SP).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.layers import attention as attn
from repro_torch.layers import moe as moe_lib
from repro_torch.layers import rglru as rglru_lib
from repro_torch.layers import xlstm as xlstm_lib
from repro_torch.layers.common import rms_norm, segment, whole_op
from repro_torch.layers.mlp import apply_ffn, init_ffn
from repro_torch.layers.positional import apply_rope
from repro_torch.models.config import ModelConfig

PORTED_KINDS = ("attn", "local_attn", "rglru", "moe", "mlstm", "slstm", "enc_attn", "dec_attn")
ATTN_IMPLS = ("full", "blocked")


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}; one of {PORTED_KINDS}")


def _slstm_ff(cfg: ModelConfig) -> int:
    # xLSTM sLSTM blocks use a ~4/3 GeGLU FFN even when cfg.d_ff == 0.
    if cfg.d_ff:
        return cfg.d_ff
    return ((int(cfg.d_model * 4 / 3) + 127) // 128) * 128


def init_block(generator, kind: str, cfg: ModelConfig, device):
    _check_kind(kind)
    dt = cfg.store_dtype
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.kq_dim
    p: Dict[str, Any] = {"norm1": torch.zeros((d,), dtype=dt, device=device)}
    if kind == "mlstm":
        p["mlstm"] = xlstm_lib.init_mlstm(generator, d, h, cfg.mlstm_proj_factor, dt, device)
        return p
    if kind == "rglru":
        p["rglru"] = rglru_lib.init_rglru(generator, d, cfg.rnn_width or d, cfg.conv_width,
                                          dt, device, cfg.num_heads)
    elif kind == "slstm":
        p["slstm"] = xlstm_lib.init_slstm(generator, d, h, dt, device)
    else:
        p["attn"] = attn.init_attn(generator, d, h, kv, hd, dt, device)
    p["norm2"] = torch.zeros((d,), dtype=dt, device=device)
    if kind == "dec_attn":
        p["cross"] = attn.init_attn(generator, d, h, kv, hd, dt, device)
        p["norm3"] = torch.zeros((d,), dtype=dt, device=device)
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(generator, cfg, cfg.moe, dt, device)
    elif kind == "slstm":
        p["ffn"] = init_ffn(generator, d, _slstm_ff(cfg), "geglu", dt, device)
    else:
        p["ffn"] = init_ffn(generator, d, cfg.d_ff, cfg.activation, dt, device)
    return p


def init_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int, device):
    """Per-block decode cache: zeroed K/V (B, C, K, D) for ``attn``,
    ``moe`` and ``dec_attn`` (which also has the cross K/V ``ck``/``cv``,
    (B, encoder frames, K, D)), a ring of ``min(window, C)`` slots for
    ``local_attn``, all in the compute dtype; for ``rglru`` the state ``h`` (B, W) in f32 and the
    conv history (B, CW-1, W) in the compute dtype; for ``mlstm`` ``C``
    (B, H, hd, hd), ``n`` (B, H, hd) and ``m`` (B, H), for ``slstm`` ``c``,
    ``n``, ``m`` and ``h`` (B, H, hd), all f32, zero but the stabiliser
    ``m`` at ``xlstm.SENTINEL``."""
    _check_kind(kind)
    dt = cfg.compute_dtype
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "mlstm":
        hd = xlstm_lib.mlstm_width(cfg.d_model, cfg.mlstm_proj_factor) // cfg.num_heads
        return {"C": torch.zeros((batch, cfg.num_heads, hd, hd), **f32),
                "n": torch.zeros((batch, cfg.num_heads, hd), **f32),
                "m": torch.full((batch, cfg.num_heads), xlstm_lib.SENTINEL, **f32)}
    if kind == "slstm":
        shape = (batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
        return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
                "m": torch.full(shape, xlstm_lib.SENTINEL, **f32), "h": torch.zeros(shape, **f32)}
    if kind == "rglru":
        w = cfg.rnn_width or cfg.d_model
        return {
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dt, device=device),
        }
    if kind == "enc_attn":
        raise ValueError("enc_attn blocks run in the encoder, which keeps no decode cache")
    if kind == "local_attn":
        capacity = min(cfg.local_window, capacity)
    shape = (batch, capacity, cfg.num_kv_heads, cfg.kq_dim)
    out = {"k": torch.zeros(shape, dtype=dt, device=device),
           "v": torch.zeros(shape, dtype=dt, device=device)}
    if kind == "dec_attn":
        frames = cfg.encoder.num_frames if cfg.encoder else 0
        shape = (batch, frames, cfg.num_kv_heads, cfg.kq_dim)
        out["ck"] = torch.zeros(shape, dtype=dt, device=device)
        out["cv"] = torch.zeros(shape, dtype=dt, device=device)
    return out


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
    if kind == "enc_attn":  # bidirectional, no cache
        if mode == "train":
            o = attn.sdpa(q, k, v, ckpt=ckpt)
        elif mode == "prefill":
            o = attn.full_attention(q, k, v, causal=False)
        else:
            raise ValueError("enc_attn blocks run in train and prefill only")
        return attn.out_proj(p["attn"], o, dt), None
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
            # torch.roll has no DTensor rule in torch 2.11: whole_op
            new = {key: whole_op(lambda t: torch.roll(t, roll, dims=1), t[:, s - w:])
                   for key, t in (("k", k), ("v", v))}
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
    _write_slots(ck, idx, k[:, 0])
    _write_slots(cv, idx, v[:, 0])
    if local:
        o = attn.decode_local_attention(q, ck, cv, cur, cfg.local_window)
    else:
        o = attn.decode_attention(q, ck, cv, cur)
    return attn.out_proj(p["attn"], o, dt), cache


def _write_slots(cache: torch.Tensor, idx: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[i, idx[i]] = new[i]`` for every row ``i``, in place.  A
    DTensor cache (its slots may be split over ``model`` by
    ``cache_pspecs``) is written on each rank's own shard: DTensor has no
    in-place rule for the indexed write on a split dim."""
    if hasattr(cache, "device_mesh"):
        _write_local_slots(cache, idx, new)
        return
    cache[torch.arange(cache.shape[0], device=cache.device), idx] = new


def _write_local_slots(cache, idx, new) -> None:
    """``_write_slots`` on a DTensor cache (B,T,...): ``new`` (B,...) and
    ``idx`` are laid out as the cache's rows and later dims, whole over
    its slots; each rank writes the slots of its own slice of T (a rank
    whose slice misses ``idx[i]`` rewrites a slot with its own value)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = cache.device_mesh, cache.placements
    off, span = 0, cache.shape[1]
    for m, p in enumerate(pl):  # mesh dims major to minor
        if p == Shard(1):
            span //= mesh.shape[m]
            off += mesh.get_local_rank(m) * span
    new_pl = [Replicate() if p == Shard(1) else Shard(p.dim - 1) if p.is_shard() and p.dim > 1
              else p for p in pl]
    idx_pl = [p if p == Shard(0) else Replicate() for p in pl]
    local = cache.to_local()
    new = ops._as_dtensor(new, mesh).redistribute(mesh, new_pl).to_local()
    i = ops._as_dtensor(idx, mesh).redistribute(mesh, idx_pl).to_local() - off
    hit = ((i >= 0) & (i < span)).reshape(-1, *[1] * (new.dim() - 1))
    rows = torch.arange(local.shape[0], device=local.device)
    j = i.clamp(0, span - 1)
    local[rows, j] = torch.where(hit, new.to(local.dtype), local[rows, j])


def _cross_attention(p, x, cfg: ModelConfig, mode: str, cache, aux, ckpt):
    """A ``dec_attn`` block's cross-attention: queries from ``x``, keys and
    values the projections of the encoder output ``aux["enc"]`` in train
    and prefill (prefill caches them as ``ck``/``cv``), the cache's in
    decode.  The plain ``sdpa`` in training, K4 with ``causal=False`` in
    prefill, K6 with every row at ``aux["cross_cur"]`` (T - 1: all T
    frames, built once a step by ``forward_hidden``) in decode, where
    JAX's ``sdpa`` is unmasked.  Returns ``(out, new cache leaves)``."""
    dt = cfg.compute_dtype
    if mode == "decode":
        ck, cv, new = cache["ck"], cache["cv"], {}
    else:
        enc = aux["enc"]
        ck = attn.project(enc, p["cross"]["wk"], dt)
        cv = attn.project(enc, p["cross"]["wv"], dt)
        new = {"ck": ck, "cv": cv} if mode == "prefill" else {}
    q = attn.project(x, p["cross"]["wq"], dt)
    if mode == "train":
        o = attn.sdpa(q, ck, cv, ckpt=ckpt)
    elif mode == "prefill":
        o = attn.full_attention(q, ck, cv, causal=False)
    else:
        o = attn.decode_attention(q, ck, cv, aux["cross_cur"])
    return attn.out_proj(p["cross"], o, dt), new


def _rglru(p, x, cfg: ModelConfig, mode: str, cache, ckpt: bool):
    dt = cfg.compute_dtype
    if mode == "decode":
        o, (hs, hist) = rglru_lib.apply_rglru_step(p["rglru"], x, (cache["h"], cache["conv"]), dt)
        cache["h"].copy_(hs)  # in place, as the attention caches
        cache["conv"].copy_(hist)
        return o, cache
    o, (hs, hist) = rglru_lib.apply_rglru(p["rglru"], x, dt, ckpt=ckpt)
    return o, ({"h": hs, "conv": hist.to(dt)} if mode == "prefill" else None)


def _mlstm(p, x, cfg: ModelConfig, mode: str, cache, ckpt: bool):
    dt = cfg.compute_dtype
    if mode == "decode":
        o, state = xlstm_lib.mlstm_step(p["mlstm"], x, (cache["C"], cache["n"], cache["m"]),
                                        cfg.num_heads, dt)
        for key, new in zip(("C", "n", "m"), state):
            cache[key].copy_(new)  # in place, as the attention caches
        return o, cache
    o, (C, n, m) = xlstm_lib.mlstm_chunkwise(p["mlstm"], x, cfg.num_heads, cfg.mlstm_chunk, dt,
                                             ckpt=ckpt)
    return o, ({"C": C, "n": n, "m": m} if mode == "prefill" else None)


def _slstm(p, x, cfg: ModelConfig, mode: str, cache):
    dt = cfg.compute_dtype
    keys = ("c", "n", "m", "h")
    if mode == "decode":
        o, state = xlstm_lib.slstm_step(p["slstm"], x, tuple(cache[k] for k in keys),
                                        cfg.num_heads, dt)
        for key, new in zip(keys, state):
            cache[key].copy_(new)
        return o, cache
    o, state = xlstm_lib.slstm_scan(p["slstm"], x, cfg.num_heads, dt)
    return o, (dict(zip(keys, state)) if mode == "prefill" else None)


def _carry(x, cfg: ModelConfig, mode: str, ctx):
    """The residual laid out as JAX lays it out (the rows over ``DP``; with
    ``sequence_parallel`` in training the sequence over ``TP``) after every
    mixer and at every block's end, as JAX's scan over layers keeps its
    carry, so that partial sums are reduced there.  Left to itself,
    DTensor reduces them where the next norm reads them, onto a split of
    its own choosing: on the 3-dim mesh, of S beside B's, which a
    product's flattening turns into a strided split that its planner takes
    a minute a product to lay out."""
    if ctx is None:
        return x
    if cfg.sequence_parallel and mode == "train":
        return ctx.hint(x, "DP", "TP", None)  # Megatron-SP residual
    return ctx.hint(x, "DP", None, None)


def apply_block(
    kind: str,
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    mode: str,
    cache=None,
    pos: Optional[torch.Tensor] = None,
    aux: Optional[Dict[str, Any]] = None,
    ctx=None,
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
    if kind == "mlstm":
        o, new_cache = _mlstm(p, h, cfg, mode, cache, ckpt)
        return _carry(x + o, cfg, mode, ctx), new_cache, 0.0
    if kind == "rglru":
        o, new_cache = _rglru(p, h, cfg, mode, cache, ckpt)
    elif kind == "slstm":
        o, new_cache = _slstm(p, h, cfg, mode, cache)
    else:
        self_kind = "attn" if kind == "dec_attn" else kind
        o, new_cache = _self_attention(p, h, cfg, self_kind, mode, cache, pos, aux, ckpt)
    x = _carry(x + o, cfg, mode, ctx)
    h2 = segment(ckpt, rms_norm, x, p["norm2"], cfg.norm_eps)
    if kind == "dec_attn":
        o, cross = _cross_attention(p, h2, cfg, mode, cache, aux, ckpt)
        if cross:
            new_cache = dict(new_cache, **cross)
        x = x + o
        h2 = segment(ckpt, rms_norm, x, p["norm3"], cfg.norm_eps)
    if kind == "moe":
        y, aloss = moe_lib.apply_moe(p["moe"], h2, cfg, cfg.moe, dt, ckpt)
        return _carry(x + y, cfg, mode, ctx), new_cache, aloss
    act = "geglu" if kind == "slstm" else cfg.activation
    y = apply_ffn(p["ffn"], h2, act, dt, ckpt)
    return _carry(x + y, cfg, mode, ctx), new_cache, 0.0
