"""Model assembly: init, forward, and the serving entry points
(``prefill_at``, ``decode_step_slots``, ``write_prefill_slot``,
``init_decode_cache``).

Parameters mirror the JAX tree: ``{"embed", "stages", "final_norm",
"lm_head"}`` with every stage a tuple (one entry per pattern position) of
dicts whose leaves are stacked on a leading ``repeats`` axis.  Decode
caches likewise: ``{"pos": (B,) int32, "stages": [tuple of {"k", "v"}
leaves (L, B, C, K, D)]}``.  A Python loop over the stacked layers takes
the place of ``lax.scan``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.layers.common import dense_init, rms_norm
from repro_torch.layers.positional import default_positions, rope_angles
from repro_torch.models.blocks import apply_block, init_block, init_cache
from repro_torch.models.config import ModelConfig


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def _layer(tree, i: int):
    return tree_map(lambda x: x[i], tree)


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
    return hidden @ w.to(cfg.compute_dtype)


def forward_hidden(cfg: ModelConfig, params, tokens: torch.Tensor, mode: str,
                   caches=None, pos=None):
    """``mode='prefill'``: returns ``(hidden, stage caches)`` with cache
    leaves stacked (L, B, S, K, D).  ``mode='decode'``: tokens (B, 1) at
    per-row positions ``pos`` (B,); the caches' leaves are updated in
    place and returned."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    offset = 0 if mode == "prefill" else pos
    aux = _rope_aux(cfg, b, s, offset, tokens.device)
    new_caches = []
    for si, (pattern, repeats) in enumerate(cfg.stages):
        sp = params["stages"][si]
        per_layer = []
        for i in range(repeats):
            out = []
            for pi, kind in enumerate(pattern):
                cache = None
                if mode == "decode":
                    cache = _layer(caches["stages"][si][pi], i)
                x, c = apply_block(kind, _layer(sp[pi], i), x, cfg, mode,
                                   cache=cache, pos=pos, aux=aux)
                out.append(c)
            per_layer.append(out)
        if mode == "prefill":
            new_caches.append(tuple(
                {key: torch.stack([layer[pi][key] for layer in per_layer])
                 for key in ("k", "v")}
                for pi in range(len(pattern))
            ))
        else:
            new_caches.append(caches["stages"][si])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_caches


# --------------------------------------------------------------- serving


def prefill_at(cfg: ModelConfig, params, tokens: torch.Tensor, lengths: torch.Tensor):
    """Right-padded prefill: logits at each row's *last real* token.

    ``tokens`` is (B, T) with row ``i`` real through ``lengths[i]`` and
    pad junk after; causal attention means positions ``< lengths[i]``
    never attend the junk, and the returned per-row KV past ``lengths``
    is overwritten by decode writes before it is ever attended.
    """
    hidden, caches = forward_hidden(cfg, params, tokens, "prefill")
    lengths = lengths.to(device=tokens.device, dtype=torch.int32)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    last = hidden[rows, lengths.long() - 1]
    return {"pos": lengths, "stages": caches}, _logits(cfg, params, last)


def decode_step_slots(cfg: ModelConfig, params, cache, tokens: torch.Tensor):
    """Per-slot decode: ``cache['pos']`` is (B,), one position per row.

    Row ``i`` appends at ``pos[i]`` (clamped to the arena's last slot) and
    attends ``<= pos[i]`` — the continuous-batching primitive.  Unlike the
    JAX function, the arena's KV leaves are updated in place; the returned
    cache holds the same leaves and ``pos + 1``.
    """
    pos = cache["pos"]
    hidden, stages = forward_hidden(cfg, params, tokens, "decode", caches=cache, pos=pos)
    logits = _logits(cfg, params, hidden[:, -1])
    return {"pos": pos + 1, "stages": stages}, logits


def write_prefill_slot(cfg: ModelConfig, arena, slot: int, pre):
    """Copy a one-row prefill cache into row ``slot`` of a decode arena,
    in place.

    ``arena`` self-attention leaves are (L, B, C, K, D); ``pre`` comes
    from a batch-1 :func:`prefill_at` with T <= C.  Returns the arena with
    ``pos[slot]`` set to the prefill's.
    """
    for si, (pattern, _) in enumerate(cfg.stages):
        for pi, _kind in enumerate(pattern):
            a, p = arena["stages"][si][pi], pre["stages"][si][pi]
            for key in ("k", "v"):
                src = p[key][:, 0]
                a[key][:, slot, : src.shape[1]] = src.to(a[key].dtype)
    arena["pos"][slot] = pre["pos"].reshape(())
    return arena


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int, device, pos=0):
    """A zeroed decode cache; mirrors prefill's structure."""
    stages = []
    for pattern, repeats in cfg.stages:
        per_pos = []
        for kind in pattern:
            one = init_cache(kind, cfg, batch, capacity, device)
            per_pos.append(tree_map(
                lambda x: x.new_zeros((repeats,) + tuple(x.shape)), one
            ))
        stages.append(tuple(per_pos))
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return {"pos": pos, "stages": stages}
