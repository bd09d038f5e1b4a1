"""Model assembly: init, forward, the training loss (``loss_fn``), and
prefill and decode: one position for the batch (``prefill``,
``decode_step``, ``extend_cache``) and the serving entry points, one
position per row (``prefill_at``, ``write_prefill_slot``, and
``decode_step`` on a (B,) ``pos``: the JAX package's
``decode_step_slots``); ``init_decode_cache`` serves both.

Parameters mirror the JAX tree: ``{"embed", "stages", "final_norm",
"lm_head"}`` with every stage a tuple (one entry per pattern position) of
dicts whose leaves are stacked on a leading ``repeats`` axis.  Decode
caches likewise: ``{"pos": () or (B,) int32, "stages": [tuple of per-kind
leaves stacked (L, ...)]}``, the kinds' leaves as ``blocks.init_cache``
makes them (``attn`` and ``moe`` K/V, ``local_attn`` rings, ``rglru``
``h`` and ``conv``, ``mlstm`` ``C``/``n``/``m`` and ``slstm``
``c``/``n``/``m``/``h``).  A Python loop over the stacked layers takes the
place of ``lax.scan``.

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
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.layers.common import cast, dense_init, recast_weights, rms_norm
from repro_torch.layers.positional import default_positions, rope_angles
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


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random parameters made on ``device`` from ``generator`` (which must
    live on the same device type)."""
    if cfg.encoder is not None or cfg.mrope_sections:
        raise NotImplementedError("encoders and M-RoPE are not ported yet")
    dt = cfg.store_dtype
    params: Dict[str, Any] = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), dt, generator, device, scale=0.02),
        "stages": [
            tuple(_stacked(generator, kind, repeats, cfg, device) for kind in pattern)
            for pattern, repeats in cfg.stages
        ],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), dt, generator, device)
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


def _run_stage_train(stage_params, pattern, repeats: int, x, cfg: ModelConfig, aux):
    """The stage's layers in training: ``(x, aux loss)``, the loss a
    Python ``0.0`` while no ``moe`` block has added to it."""
    if cfg.remat == "dots":
        aux = dict(aux, remat_segments=True)

    def body(x, lp):
        aloss = 0.0
        for pi, kind in enumerate(pattern):
            x, _, a = apply_block(kind, lp[pi], x, cfg, "train", aux=aux)
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


def _rope_aux(cfg: ModelConfig, batch_size: int, seq: int, offset, device):
    if not cfg.rope:
        return {}
    positions = default_positions(batch_size, seq, offset, device)
    return {"rope_angles": rope_angles(positions, cfg.kq_dim, cfg.rope_theta)}


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.compute_dtype)


def _logits(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden @ cast(w, cfg.compute_dtype)


def forward_hidden(cfg: ModelConfig, params, tokens: torch.Tensor, mode: str,
                   caches=None, pos=None):
    """Returns ``(hidden, stage caches, aux loss)``.  ``mode='train'``: no
    caches; each pattern period rematerialised per ``cfg.remat``.
    ``mode='prefill'``: every cache leaf stacked (L, B, ...).
    ``mode='decode'``: tokens (B, 1) at position ``pos``, one for the
    batch (a 0-d tensor) or one per row (B,); the caches' leaves are
    updated in place and returned.  The aux loss (an f32 scalar) sums
    the ``moe`` blocks' load-balancing losses in training; it is zero
    in prefill and decode, whose callers drop it."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train|prefill|decode, got {mode!r}")
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    offset = pos if mode == "decode" else 0
    aux = _rope_aux(cfg, b, s, offset, tokens.device)
    aloss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    new_caches = []
    for si, (pattern, repeats) in enumerate(cfg.stages):
        sp = params["stages"][si]
        if mode == "train":
            x, a = _run_stage_train(sp, pattern, repeats, x, cfg, aux)
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
                                      cache=cache, pos=pos, aux=aux)
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


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token cross-entropy over labels >= 0 (negative labels are
    masked), plus ``AUX_LOSS_WEIGHT`` times the aux loss.  ``batch``:
    ``tokens`` and ``labels`` (B, S) int tensors.  The logits are taken in
    the compute dtype, then f32; ``cfg.loss_chunk`` splits the sequence
    into chunks summed in order; ``cfg.loss_impl`` is "log_softmax" or
    "lse".  Returns ``(loss, {"ce", "aux"})``."""
    tokens, labels = batch["tokens"], batch["labels"]
    extras = sorted(set(batch) - {"tokens", "labels"})
    if extras:
        raise NotImplementedError(f"batch extras {extras} are not ported yet")
    hidden, _, aloss = forward_hidden(cfg, params, tokens, "train")
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


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor):
    """Prefill a whole batch of ``S`` tokens: logits at the last token and
    a decode cache at the scalar position ``S``.  ``local_attn`` rings hold
    ``min(window, S)`` slots, as in the JAX package: after a prompt shorter
    than the window, decode wraps inside a ring of the prompt's length."""
    hidden, caches, _ = forward_hidden(cfg, params, tokens, "prefill")
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    return {"pos": pos, "stages": caches}, _logits(cfg, params, hidden[:, -1])


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor):
    """tokens: (B, 1), appended at ``cache['pos']``: a scalar for the
    batch (a 0-d tensor), or one position per row (B,), where row ``i``
    appends at ``pos[i]`` (clamped to the arena's last slot) and attends
    ``<= pos[i]``: the JAX package's ``decode_step_slots``, the
    continuous-batching primitive.  Unlike the JAX functions, the cache's
    leaves are updated in place; the returned cache holds the same leaves
    and ``pos + 1``."""
    pos = cache["pos"]
    hidden, stages, _ = forward_hidden(cfg, params, tokens, "decode", caches=cache, pos=pos)
    return {"pos": pos + 1, "stages": stages}, _logits(cfg, params, hidden[:, -1])


def extend_cache(cfg: ModelConfig, cache, extra: int):
    """Pad the ``attn`` and ``moe`` K/V capacity of a prefill cache by ``extra``
    positions (new leaves); local-attention rings and recurrent state
    leaves are untouched.  Stacked leaves are (L, B, T, K, D)."""
    stages = []
    for si, (pattern, _) in enumerate(cfg.stages):
        per_pos = []
        for pi, kind in enumerate(pattern):
            c = cache["stages"][si][pi]
            if kind in ("attn", "moe"):
                c = {key: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, extra))
                     for key, x in c.items()}
            per_pos.append(c)
        stages.append(tuple(per_pos))
    return {"pos": cache["pos"], "stages": stages}


def prefill_at(cfg: ModelConfig, params, tokens: torch.Tensor, lengths: torch.Tensor):
    """Right-padded prefill: logits at each row's *last real* token.

    ``tokens`` is (B, T) with row ``i`` real through ``lengths[i]`` and
    pad junk after; causal attention means positions ``< lengths[i]``
    never attend the junk, and the returned per-row KV past ``lengths``
    is overwritten by decode writes before it is ever attended.
    """
    hidden, caches, _ = forward_hidden(cfg, params, tokens, "prefill")
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
