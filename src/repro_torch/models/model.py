"""Model assembly: init, forward, the training loss (``loss_fn``), and
prefill and decode: one position for the batch (``prefill``,
``decode_step``, ``extend_cache``) and the serving entry points, one
position per row (``prefill_at``, ``write_prefill_slot``, and
``decode_step`` on a (B,) ``pos``: the JAX package's
``decode_step_slots``); ``init_decode_cache`` serves both.

Parameters mirror the JAX tree: ``{"embed", "stages", "final_norm",
"lm_head"}`` with every stage a tuple (one entry per pattern position) of
dicts whose leaves are stacked on a leading ``repeats`` axis, and for a
config with an encoder (whisper) ``"encoder": {"stages", "norm"}`` plus
``"proj"`` where ``d_input != d_model``.  Decode caches likewise:
``{"pos": () or (B,) int32, "stages": [tuple of per-kind leaves stacked
(L, ...)]}``, the kinds' leaves as ``blocks.init_cache`` makes them
(``attn`` and ``moe`` K/V, ``dec_attn`` K/V and cross K/V ``ck``/``cv``,
``local_attn`` rings, ``rglru`` ``h`` and ``conv``, ``mlstm``
``C``/``n``/``m`` and ``slstm`` ``c``/``n``/``m``/``h``).  A Python loop
over the stacked layers takes the place of ``lax.scan``.

The batch extras, as in the JAX package: ``encoder_frames`` (B, frames,
d_input), the encoder's input in training and prefill (decode reads the
cross K/V from the cache); ``positions`` (B, S), RoPE's positions;
``positions_3d`` (B, 3, S), M-RoPE's (temporal, height, width) streams.
A missing position extra defaults to ``offset + arange(S)`` (per stream).
A key the config would not read, which JAX ignores, is refused by name.

Training rematerialises as the JAX package's ``_remat_wrap`` does, with
``torch.utils.checkpoint``.  ``remat="full"`` checkpoints one pattern
period at a time: it drops the period's activations after the forward
and recomputes the whole period in the backward.  ``remat="dots"`` (the
default) is JAX's ``checkpoint_dots``: no period-level checkpoint, but
every stretch of a block's work between two matrix products (norms,
RoPE, softmax, the conv, gates and scan, activations, MoE routing) is a
checkpointed segment (``layers.common.segment``), so the backward
recomputes the segments and no product.  The products keep their
activation inputs and outputs as autograd saves them (JAX's policy
recomputes the inputs too), but no weight cast: each period and the
logits' product run under ``layers.common.recast_weights``, so the
backward casts the f32 weights again.

SPMD: every entry point takes ``ctx`` (``layers.common.ShardCtx``).  With
a mesh, the parameters, batch and cache are DTensors laid out by
:mod:`repro_torch.sharding.specs`; the embedding output is laid out over
the data dims and the blocks lay out their residuals (``blocks.
apply_block``), where JAX's ``ctx.hint`` constrains them.  The entry
points then run under ``common.spmd_scope`` (DTensor's
``implicit_replication``): the plain constants made inside the model
(masks, default positions, zeros) count as replicated, not converted one
by one.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.layers.common import (
    cast,
    dense_init,
    recast_weights,
    rms_norm,
    spmd_scope,
)
from repro_torch.layers.positional import (
    default_positions,
    mrope_angles,
    rope_angles,
    sinusoidal,
)
from repro_torch.models.blocks import apply_block, init_block, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.utils.tree import (
    flatten_with_path,
    path_str,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

AUX_LOSS_WEIGHT = 0.01


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def _layer(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def _unstack(tree, repeats: int):
    """The per-layer trees of a stacked stage, as views from one
    ``unbind`` per leaf: autograd then stacks the layers' gradients once,
    where ``x[i]`` per layer would scatter each into a full-size zero
    tensor."""
    parts = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[i] for p in parts]) for i in range(repeats)]


# ------------------------------------------------------------------ init


def _stacked(generator, kind: str, repeats: int, cfg: ModelConfig, device):
    """Init ``repeats`` blocks one at a time into preallocated stacked
    leaves, so the transient memory is one layer, not one stage."""
    out = None
    for i in range(repeats):
        p = init_block(generator, kind, cfg, device)
        if out is None:
            out = tree_map(lambda x: x.new_empty((repeats,) + tuple(x.shape)), p)
        _copy_into(_layer(out, i), p)
    return out


def _init_stages(generator, stages, cfg: ModelConfig, device):
    return [tuple(_stacked(generator, kind, repeats, cfg, device) for kind in pattern)
            for pattern, repeats in stages]


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random parameters made on ``device`` from ``generator`` (which must
    live on the same device type)."""
    dt = cfg.store_dtype
    params: Dict[str, Any] = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), dt, generator, device, scale=0.02),
        "stages": _init_stages(generator, cfg.stages, cfg, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), dt, generator, device)
    if cfg.encoder is not None:
        enc: Dict[str, Any] = {"stages": _init_stages(generator, cfg.encoder.stages, cfg, device)}
        if cfg.encoder.d_input != cfg.d_model:
            enc["proj"] = dense_init((cfg.encoder.d_input, cfg.d_model), dt, generator, device)
        enc["norm"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        params["encoder"] = enc
    return params


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``, counted from shapes on the meta device
    (nothing is allocated).  ``active_only``: routed expert weights count
    ``experts_per_token / num_experts`` of their size, as JAX's
    ``param_count``."""
    shapes = init_params(cfg, None, torch.device("meta"))
    if not active_only or cfg.moe is None:
        return int(sum(math.prod(x.shape) for x in tree_leaves(shapes)))
    frac = cfg.moe.experts_per_token / cfg.moe.num_experts
    total = 0.0
    for path, x in flatten_with_path(shapes):
        n = math.prod(x.shape)
        p = path_str(path)
        if "/moe/w_" in "/" + p and "shared" not in p:
            n = n * frac
        total += n
    return int(total)


# ------------------------------------------------------------ stage loop


def _remat_wrap(fn, cfg: ModelConfig):
    """The pattern period's body under ``remat="full"``; ``"dots"``
    checkpoints the blocks' segments instead, and ``"none"`` nothing."""
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"remat must be none|dots|full, got {cfg.remat!r}")
    if cfg.remat != "full":
        return fn
    # the forward draws no random numbers, so no RNG state needs replaying
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)


def _recast_scope(cfg: ModelConfig):
    """Under ``remat="dots"``, the backward casts the weights again
    (``recast_weights``): no bf16 weight cast is saved."""
    return recast_weights() if cfg.remat == "dots" else contextlib.nullcontext()


def _run_stage_train(stage_params, pattern, repeats: int, x, cfg: ModelConfig, aux, ctx=None):
    """The stage's layers in training: ``(x, aux loss)``, the loss a
    Python ``0.0`` while no ``moe`` block has added to it."""
    if cfg.remat == "dots":
        aux = dict(aux, remat_segments=True)

    def body(x, lp):
        aloss = 0.0
        for pi, kind in enumerate(pattern):
            x, _, a = apply_block(kind, lp[pi], x, cfg, "train", aux=aux, ctx=ctx)
            aloss = aloss + a
        return x, aloss

    body = _remat_wrap(body, cfg)
    aloss = 0.0
    for lp in _unstack(stage_params, repeats):
        with _recast_scope(cfg):
            x, a = body(x, lp)
        aloss = aloss + a
    return x, aloss


# --------------------------------------------------------------- forward


def _check_extras(cfg: ModelConfig, extras, mode: str) -> None:
    """Refuse, by name, an extra this config and mode would not read (JAX
    ignores it), and a missing ``encoder_frames`` where the encoder runs."""
    read = set()
    if cfg.encoder is not None and mode != "decode":
        read.add("encoder_frames")
    if cfg.mrope_sections:
        read.add("positions_3d")
    elif cfg.rope:
        read.add("positions")
    unread = sorted(set(extras) - read)
    if unread:
        raise ValueError(f"{cfg.name} does not read the batch extras {unread} in {mode} "
                         f"(it reads {sorted(read) or 'none'})")
    if "encoder_frames" in read and "encoder_frames" not in extras:
        enc = cfg.encoder
        raise ValueError(f"{cfg.name} has an encoder: {mode} needs the batch extra "
                         f"encoder_frames (B, {enc.num_frames}, {enc.d_input})")


def _rope_aux(cfg: ModelConfig, batch_size: int, seq: int, offset, device, extras):
    """RoPE or M-RoPE angles from the position extras, else from
    ``offset + arange(seq)`` (``offset`` the decode position)."""
    if not cfg.rope and not cfg.mrope_sections:
        return {}
    if cfg.mrope_sections:
        p3 = extras.get("positions_3d")
        if p3 is None:
            base = default_positions(batch_size, seq, offset, device)
            p3 = torch.stack([base, base, base], dim=1)
        return {"rope_angles": mrope_angles(p3, cfg.kq_dim, cfg.rope_theta, cfg.mrope_sections)}
    positions = extras.get("positions")
    if positions is None:
        positions = default_positions(batch_size, seq, offset, device)
    return {"rope_angles": rope_angles(positions, cfg.kq_dim, cfg.rope_theta)}


def _embed_layout(mesh, w, ids):
    """The gather on each rank's shard of the table, as JAX's spec rules
    lay the table out (``sharding.specs``): on a mesh dim that splits the
    table's d, the ids are whole and the rows come out with their d split
    there; on one that splits its vocab, the ids are whole, each rank
    gathers its rows (the rest are zero) and the rows are partial sums; on
    any other, the ids keep their split and the rows follow it, and the
    table's gradient sums the rank's ids only (partial sums)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    whole = (Replicate(),) * mesh.ndim
    w_pl, idp = (tuple(getattr(t, "placements", whole)) for t in (w, ids))
    ids_pl, out_pl, dw_pl = [], [], []
    for wp, ip in zip(w_pl, idp):
        if wp == Shard(1) or wp == Shard(0):
            ids_pl.append(Replicate())
            out_pl.append(Shard(ids.dim()) if wp == Shard(1) else Partial())
            dw_pl.append(wp)
        else:
            split = ip if ip.is_shard() else Replicate()
            ids_pl.append(split)
            out_pl.append(split)
            dw_pl.append(Partial() if ip.is_shard() else Replicate())
    lo = None
    if Shard(0) in w_pl:
        lo = compute_local_shape_and_global_offset(w.shape, mesh, w_pl)[1][0]
    return tuple(out_pl), (w_pl, tuple(ids_pl)), \
        (tuple(dw_pl), tuple(ids_pl)), (w, ids, lo)


@ops.local_shards(_embed_layout)
def _gather_rows(w, ids, lo=None):
    """``w[ids]``; with ``lo``, ``w`` holds the rows ``lo, lo + 1, ...``
    of the table and the ids outside them give zero rows."""
    if lo is None:
        return w[ids]
    local = ids - lo
    hit = (local >= 0) & (local < w.shape[0])
    return torch.where(hit[..., None], w[torch.where(hit, local, 0)], 0.0)


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of the embedding, in the compute dtype: on
    DTensors, gathered on each rank's shard of the table
    (``_embed_layout``); ``forward_hidden`` then lays the rows out."""
    return _gather_rows(params["embed"], tokens).to(cfg.compute_dtype)


def _logits(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden @ cast(w, cfg.compute_dtype)


def encode(cfg: ModelConfig, params, frames: torch.Tensor, mode: str = "train",
           ctx=None) -> torch.Tensor:
    """The whisper-style encoder over precomputed (stub) frontend frames
    (B, F, d_input): cast to the compute dtype, the optional ``proj``,
    plus the sinusoidal table, the encoder stages (no RoPE), then the
    encoder's norm.  ``mode='train'`` runs the stages through
    ``_run_stage_train`` (remat as the decoder's), ``'prefill'`` as a
    plain layer loop whose attention is K4 with ``causal=False``; both
    compute JAX's ``encode``.  Its aux loss is dropped, as in JAX."""
    enc = params["encoder"]
    dt = cfg.compute_dtype
    x = frames.to(dt)
    if "proj" in enc:
        x = x @ cast(enc["proj"], dt)
    x = x + sinusoidal(x.shape[1], cfg.d_model, dt, x.device)
    for si, (pattern, repeats) in enumerate(cfg.encoder.stages):
        sp = enc["stages"][si]
        if mode == "train":
            x, _ = _run_stage_train(sp, pattern, repeats, x, cfg, {}, ctx)
            continue
        for lp in _unstack(sp, repeats):
            for pi, kind in enumerate(pattern):
                x, _, _ = apply_block(kind, lp[pi], x, cfg, mode, ctx=ctx)
    return rms_norm(x, enc["norm"], cfg.norm_eps)


def forward_hidden(cfg: ModelConfig, params, tokens: torch.Tensor, mode: str,
                   caches=None, pos=None, extras=None, ctx=None):
    """Returns ``(hidden, stage caches, aux loss)``.  ``mode='train'``: no
    caches; each pattern period rematerialised per ``cfg.remat``.
    ``mode='prefill'``: every cache leaf stacked (L, B, ...).
    ``mode='decode'``: tokens (B, 1) at position ``pos``, one for the
    batch (a 0-d tensor) or one per row (B,); the caches' leaves are
    updated in place and returned.  ``extras``: the batch extras (module
    docstring).  The aux loss (an f32 scalar) sums the ``moe`` blocks'
    load-balancing losses in training; it is zero in prefill and decode,
    whose callers drop it.  ``ctx``: the layout (module docstring)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train|prefill|decode, got {mode!r}")
    extras = extras or {}
    _check_extras(cfg, extras, mode)
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    if ctx is not None:
        x = ctx.hint(x, "DP", None, None)
    offset = pos if mode == "decode" else 0
    aux = _rope_aux(cfg, b, s, offset, tokens.device, extras)
    if "encoder_frames" in extras:
        aux["enc"] = encode(cfg, params, extras["encoder_frames"], mode, ctx)
    if mode == "decode" and cfg.encoder is not None:
        # cross-attention attends every cached frame: cur = T - 1 on every row
        t = next(c["ck"].shape[2] for stage in caches["stages"] for c in stage if "ck" in c)
        aux["cross_cur"] = torch.full((b,), t - 1, dtype=torch.int32, device=tokens.device)
    aloss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    new_caches = []
    for si, (pattern, repeats) in enumerate(cfg.stages):
        sp = params["stages"][si]
        if mode == "train":
            x, a = _run_stage_train(sp, pattern, repeats, x, cfg, aux, ctx)
            aloss = aloss + a
            continue
        per_layer = []
        for i in range(repeats):
            out = []
            for pi, kind in enumerate(pattern):
                cache = None
                if mode == "decode":
                    cache = _layer(caches["stages"][si][pi], i)
                x, c, _ = apply_block(kind, _layer(sp[pi], i), x, cfg, mode,
                                      cache=cache, pos=pos, aux=aux, ctx=ctx)
                out.append(c)
            per_layer.append(out)
        if mode == "prefill":
            new_caches.append(tuple(
                {key: torch.stack([layer[pi][key] for layer in per_layer])
                 for key in per_layer[0][pi]}
                for pi in range(len(pattern))
            ))
        else:
            new_caches.append(caches["stages"][si])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_caches, aloss


# ------------------------------------------------------------------ loss


def loss_fn(cfg: ModelConfig, params, batch, ctx=None):
    """Mean next-token cross-entropy over labels >= 0 (negative labels are
    masked), plus ``AUX_LOSS_WEIGHT`` times the aux loss.  ``batch``:
    ``tokens`` and ``labels`` (B, S) int tensors, and the extras the
    config reads (module docstring).  The logits are taken in the compute
    dtype, then f32; ``cfg.loss_chunk`` splits the sequence into chunks
    summed in order; ``cfg.loss_impl`` is "log_softmax" or "lse".
    Returns ``(loss, {"ce", "aux"})``."""
    with spmd_scope(ctx):
        return _loss(cfg, params, batch, ctx)


def _loss(cfg: ModelConfig, params, batch, ctx):
    tokens, labels = batch["tokens"], batch["labels"]
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    hidden, _, aloss = forward_hidden(cfg, params, tokens, "train", extras=extras, ctx=ctx)
    valid = (labels >= 0).float()
    safe_labels = labels.clamp(min=0).long()

    def ce(h, lab, val):
        with _recast_scope(cfg):
            logits = _logits(cfg, params, h).float()
        idx = lab[..., None]
        if cfg.loss_impl == "lse":
            nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, idx)[..., 0]
        else:
            nll = -torch.log_softmax(logits, dim=-1).gather(-1, idx)[..., 0]
        return (nll * val).sum(), val.sum()

    chunk = cfg.loss_chunk
    if chunk and hidden.shape[1] % chunk == 0:
        tot = cnt = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for c0 in range(0, hidden.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            s_, n_ = ce(hidden[:, sl], safe_labels[:, sl], valid[:, sl])
            tot, cnt = tot + s_, cnt + n_
    else:
        tot, cnt = ce(hidden, safe_labels, valid)
    loss = tot / cnt.clamp(min=1.0)
    return loss + AUX_LOSS_WEIGHT * aloss, {"ce": loss, "aux": aloss}


# --------------------------------------------------------------- serving


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, extras=None, ctx=None):
    """Prefill a whole batch of ``S`` tokens: logits at the last token and
    a decode cache at the scalar position ``S``.  ``local_attn`` rings hold
    ``min(window, S)`` slots, as in the JAX package: after a prompt shorter
    than the window, decode wraps inside a ring of the prompt's length."""
    with spmd_scope(ctx):
        hidden, caches, _ = forward_hidden(cfg, params, tokens, "prefill", extras=extras,
                                           ctx=ctx)
        pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        return {"pos": pos, "stages": caches}, _logits(cfg, params, hidden[:, -1])


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor, extras=None, ctx=None):
    """tokens: (B, 1), appended at ``cache['pos']``: a scalar for the
    batch (a 0-d tensor), or one position per row (B,), where row ``i``
    appends at ``pos[i]`` (clamped to the arena's last slot) and attends
    ``<= pos[i]``: the JAX package's ``decode_step_slots``, the
    continuous-batching primitive.  Unlike the JAX functions, the cache's
    leaves are updated in place; the returned cache holds the same leaves
    and ``pos + 1``.  ``extras``: this step's ``positions`` (B, 1) or
    ``positions_3d`` (B, 3, 1), else ``pos``."""
    pos = cache["pos"]
    with spmd_scope(ctx):
        hidden, stages, _ = forward_hidden(cfg, params, tokens, "decode", caches=cache,
                                           pos=pos, extras=extras, ctx=ctx)
        return {"pos": pos + 1, "stages": stages}, _logits(cfg, params, hidden[:, -1])


def extend_cache(cfg: ModelConfig, cache, extra: int):
    """Pad the self-attention K/V capacity (``attn``, ``moe``, ``dec_attn``)
    of a prefill cache by ``extra`` positions (new leaves); the cross K/V,
    local-attention rings and recurrent state leaves are untouched.
    Stacked leaves are (L, B, T, K, D)."""
    stages = []
    for si, (pattern, _) in enumerate(cfg.stages):
        per_pos = []
        for pi, kind in enumerate(pattern):
            c = cache["stages"][si][pi]
            if kind in ("attn", "moe", "dec_attn"):
                c = dict(c)
                for key in ("k", "v"):
                    c[key] = torch.nn.functional.pad(c[key], (0, 0, 0, 0, 0, extra))
            per_pos.append(c)
        stages.append(tuple(per_pos))
    return {"pos": cache["pos"], "stages": stages}


def prefill_at(cfg: ModelConfig, params, tokens: torch.Tensor, lengths: torch.Tensor,
               extras=None, ctx=None):
    """Right-padded prefill: logits at each row's *last real* token.

    ``tokens`` is (B, T) with row ``i`` real through ``lengths[i]`` and
    pad junk after; causal attention means positions ``< lengths[i]``
    never attend the junk, and the returned per-row KV past ``lengths``
    is overwritten by decode writes before it is ever attended.
    """
    with spmd_scope(ctx):
        hidden, caches, _ = forward_hidden(cfg, params, tokens, "prefill", extras=extras,
                                           ctx=ctx)
        lengths = lengths.to(device=tokens.device, dtype=torch.int32)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        last = hidden[rows, lengths.long() - 1]
        return {"pos": lengths, "stages": caches}, _logits(cfg, params, last)


def write_prefill_slot(cfg: ModelConfig, arena, slot: int, pre):
    """Copy a one-row prefill cache into row ``slot`` of a decode arena,
    in place.

    ``arena`` self-attention leaves are (L, B, C, K, D); ``pre`` comes
    from a batch-1 :func:`prefill_at` with T <= C.  Returns the arena with
    ``pos[slot]`` set to the prefill's.
    """
    for si, (pattern, _) in enumerate(cfg.stages):
        for pi, kind in enumerate(pattern):
            if kind not in ("attn", "moe"):  # the engine serves these kinds only
                continue
            a, p = arena["stages"][si][pi], pre["stages"][si][pi]
            for key in ("k", "v"):
                src = p[key][:, 0]
                a[key][:, slot, : src.shape[1]] = src.to(a[key].dtype)
    arena["pos"][slot] = pre["pos"].reshape(())
    return arena


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int, device, pos=0):
    """An empty decode cache; mirrors prefill's structure.  Each leaf
    repeats ``blocks.init_cache``'s values over the stacked layers, as
    JAX's broadcast does: zeros, but the xLSTM stabilisers ``m`` at
    ``xlstm.SENTINEL``."""
    stages = []
    for pattern, repeats in cfg.stages:
        per_pos = []
        for kind in pattern:
            one = init_cache(kind, cfg, batch, capacity, device)
            per_pos.append(tree_map(
                lambda x: x.expand((repeats,) + tuple(x.shape)).contiguous(), one
            ))
        stages.append(tuple(per_pos))
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return {"pos": pos, "stages": stages}
