"""Mixture-of-Experts FFN, the port of ``repro.layers.moe``: the same two
dispatches, the same parameter tree.

``dense``  — one-hot dispatch and combine products with a fixed
             capacity per group of tokens: a (token, choice) pair beyond
             its expert's capacity is dropped (its slot is the running
             count over the group's flattened ``(s·k)`` pairs, so an
             earlier token wins a full expert).
``ragged`` — the (token, choice) pairs sorted by expert (a stable sort),
             one grouped product per weight, a scatter-add back: nothing
             is dropped.  JAX's ``jax.lax.ragged_dot`` is an XLA op; here
             it is a loop over the experts' slices, whose sizes the host
             reads (one sync a layer).

The router runs in f32 (softmax, top-k sorted descending, gates
renormalised).  Both return ``(y, aux)``: ``aux`` is the Switch
load-balancing loss ``E · Σ density · mean_probs``, density taken from
each token's first choice.  Every one-hot is built in the compute dtype
(a comparison against ``arange``), never as ``F.one_hot``'s int64.  With
``ckpt`` the work between the products (routing, the one-hots, the
activations, the scatter) runs in remat segments (``common.segment``).

On DTensors the dense dispatch, the experts' products and the combine
run on each rank's local shards (``_experts``, through
``ops.local_shards``), laid out as JAX's spec rules lay the weights out:
the rows over the data dims, the experts over ``model`` where it divides
them, else the expert-ff dim; the output is a partial sum over ``model``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.layers.common import activation_fn, cast, dense_init, replicate_dims, segment
from repro_torch.layers.mlp import gated
from repro_torch.models.config import ModelConfig, MoEConfig

MOE_IMPLS = ("dense", "ragged")


def init_moe(generator, cfg: ModelConfig, moe: MoEConfig, dtype, device):
    d, e, f = cfg.d_model, moe.num_experts, moe.d_ff_expert
    p = {
        "router": dense_init((d, e), dtype, generator, device, scale=0.02),
        "w_in": dense_init((e, d, f), dtype, generator, device),
        "w_gate": dense_init((e, d, f), dtype, generator, device),
        "w_out": dense_init((e, f, d), dtype, generator, device),
    }
    if moe.num_shared_experts:
        p["shared"] = {
            "w_in": dense_init((d, moe.d_ff_shared), dtype, generator, device),
            "w_gate": dense_init((d, moe.d_ff_shared), dtype, generator, device),
            "w_out": dense_init((moe.d_ff_shared, d), dtype, generator, device),
        }
    return p


def _capacity(moe: MoEConfig, seq: int) -> int:
    cap = int(math.ceil(moe.experts_per_token * seq * moe.capacity_factor / moe.num_experts))
    return max(8, ((cap + 7) // 8) * 8)


def _route(logits, k: int):
    """Softmax, top-k and renormalised gates ``(B,S,k)``, the ids, and
    the aux loss."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1)  # sorted, descending
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    first = (ids[..., :1] == torch.arange(e, device=ids.device)).float()
    density = first.mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    return gate, ids, e * (density * mean_probs).sum()


def _router(params, x, moe: MoEConfig, ckpt: bool):
    logits = x.float() @ params["router"].float()
    return segment(ckpt, _route, logits, moe.experts_per_token)


def _dispatch_combine(gate, ids, experts, cap: int, dtype):
    """The (B,S,E,C) dispatch and combine tensors in ``dtype`` for the
    experts ``experts`` (their ids, (E,)), built one choice at a time as
    JAX builds them.  Each expert's slots count its own pairs only, so a
    slice of the experts gives the same columns as all of them."""
    b, s, k = ids.shape
    e = experts.shape[0]
    mask = ids[..., None] == experts  # (B,S,k,E)
    flat = mask.reshape(b, s * k, e).to(torch.int32)
    pos = (torch.cumsum(flat, dim=1, dtype=torch.int32) * flat - 1).reshape(b, s, k, e)
    keep = (pos >= 0) & (pos < cap) & mask
    slots = torch.arange(cap, device=ids.device)
    dispatch = torch.zeros((b, s, e, cap), dtype=dtype, device=ids.device)
    combine = torch.zeros((b, s, e, cap), dtype=dtype, device=ids.device)
    for j in range(k):  # k is small; keeps peak memory at one (B,S,E,C)
        oh = (pos[:, :, j, :, None].clamp(0, cap - 1) == slots).to(dtype)
        oh = oh * keep[:, :, j, :, None].to(dtype)
        dispatch = dispatch + oh
        combine = combine + oh * gate[:, :, j, None, None].to(dtype)
    return dispatch, combine


def _experts_layout(mesh, gate, ids, experts, x, w_in, w_gate, w_out, *rest):
    """The dense dispatch as JAX's spec rules lay it out: the rows (gate,
    ids, x, y) over the data dims, the experts over ``model`` where it
    divides them, else the expert-ff dim over ``model``.  Either way a
    rank's products sum only its share of the experts or of ``f``, so ``y``
    and the gradients of ``gate`` and ``x`` are partial sums over
    ``model``, and a weight's gradient sums its rank's rows only: partial
    sums over the data dims that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    kp = ops._kernel_placements
    b, e, f = x.shape[0], w_in.shape[0], w_in.shape[2]
    rows = kp(mesh, b, None, ())
    w = kp(mesh, b, 0, (e,), batch_dim=None)
    if w == kp(mesh, b, None, (), batch_dim=None):
        w = kp(mesh, b, 2, (f,), batch_dim=None)
    w_o = tuple(Shard(1) if p == Shard(2) else p for p in w)
    ex = tuple(p if p == Shard(0) else Replicate() for p in w)
    red = tuple(Partial() if q.is_shard() else p for p, q in zip(rows, w))
    dw, dw_o = (tuple(Partial() if r.is_shard() else p for r, p in zip(rows, pl))
                for pl in (w, w_o))
    return (red, (rows, rows, ex, rows, w, w, w_o), (red, rows, ex, red, dw, dw, dw_o),
            (gate, ids, experts, x, w_in, w_gate, w_out, *rest))


@ops.local_shards(_experts_layout)
def _experts(gate, ids, experts, x, w_in, w_gate, w_out, *, cap: int, act, dtype, ckpt: bool):
    """Dispatch, the experts' products and combine: (B,S,d) from the
    routing (gate, ids), the experts' ids and the weights in ``dtype``."""
    dispatch, combine = segment(ckpt, _dispatch_combine, gate, ids, experts, cap, dtype)
    xin = torch.einsum("bsec,bsd->ebcd", dispatch, x)  # (E,B,C,d)
    h = torch.einsum("ebcd,edf->ebcf", xin, w_in)
    gt = torch.einsum("ebcd,edf->ebcf", xin, w_gate)
    h = segment(ckpt, gated, act, gt, h)
    yout = torch.einsum("ebcf,efd->ebcd", h, w_out)
    return torch.einsum("ebcd,bsec->bsd", yout, combine)


def apply_moe_dense(params, x, cfg: ModelConfig, moe: MoEConfig, dtype, ckpt: bool = False):
    """Dispatch cost is O(B·S·E·C·d) with C = k·cf·group/E: quadratic in
    the group length; ``moe.group_size`` regroups the sequence into
    groups of that many tokens where it divides the sequence."""
    b0, s0, d0 = x.shape
    g = moe.group_size or s0
    if 0 < g < s0 and s0 % g == 0:
        x = x.reshape(b0 * (s0 // g), g, d0)
    _, s, _ = x.shape
    cap = _capacity(moe, s)
    gate, ids, aux = _router(params, x, moe, ckpt)
    x = replicate_dims(x, 1, 2)
    experts = torch.arange(moe.num_experts, device=ids.device)
    w = (cast(params[k], dtype) for k in ("w_in", "w_gate", "w_out"))
    y = _experts(gate, ids, experts, x, *w, cap=cap, act=activation_fn(cfg.activation),
                 dtype=dtype, ckpt=ckpt)
    if "shared" in params:
        y = y + _shared(params["shared"], x, cfg, dtype, ckpt)
    return y.reshape(b0, s0, d0), aux


def ragged_dot(x, w, sizes):
    """``jax.lax.ragged_dot``: rows ``x`` (N, d) in consecutive groups of
    ``sizes`` (host ints), group i times ``w[i]`` (d, f)."""
    return torch.cat([xi @ w[i] for i, xi in enumerate(torch.split(x, sizes))])


def _scatter(out, gate, order, sorted_tok, n: int):
    w = gate.reshape(-1)[order][:, None]
    return torch.zeros((n, out.shape[1]), dtype=out.dtype, device=out.device).index_add(
        0, sorted_tok, out * w)


def apply_moe_ragged(params, x, cfg: ModelConfig, moe: MoEConfig, dtype, ckpt: bool = False):
    b, s, d = x.shape
    k, e = moe.experts_per_token, moe.num_experts
    gate, ids, aux = _router(params, x, moe, ckpt)
    tokens = x.reshape(b * s, d)
    # replicate each token k times, sort the (token, expert) pairs by expert
    rep_ids = ids.reshape(-1)
    rep_tok = torch.arange(b * s, device=x.device).repeat_interleave(k)
    order = torch.argsort(rep_ids, stable=True)
    sorted_tok = rep_tok[order]
    sizes = torch.bincount(rep_ids, minlength=e).tolist()
    gathered = tokens[sorted_tok]  # (T·k, d)
    h = ragged_dot(gathered, cast(params["w_in"], dtype), sizes)
    g = ragged_dot(gathered, cast(params["w_gate"], dtype), sizes)
    h = segment(ckpt, gated, activation_fn(cfg.activation), g, h)
    out = ragged_dot(h, cast(params["w_out"], dtype), sizes)  # (T·k, d)
    y = segment(ckpt, _scatter, out, gate.to(dtype), order, sorted_tok, b * s).reshape(b, s, d)
    if "shared" in params:
        y = y + _shared(params["shared"], x, cfg, dtype, ckpt)
    return y, aux


def _shared(sp, x, cfg: ModelConfig, dtype, ckpt: bool):
    h = x @ cast(sp["w_in"], dtype)
    h = segment(ckpt, gated, activation_fn(cfg.activation), x @ cast(sp["w_gate"], dtype), h)
    return h @ cast(sp["w_out"], dtype)


def apply_moe(params, x, cfg: ModelConfig, moe: MoEConfig, dtype, ckpt: bool = False):
    """The ``moe`` block's FFN: ``(y, aux loss)``.  ``moe.impl`` must be
    "dense" or "ragged" (JAX's ``apply_moe`` takes any other name as
    "dense"; the port refuses it)."""
    if moe.impl not in MOE_IMPLS:
        raise ValueError(f"moe.impl must be one of {MOE_IMPLS}, got {moe.impl!r}")
    if moe.impl == "ragged":
        return apply_moe_ragged(params, x, cfg, moe, dtype, ckpt)
    return apply_moe_dense(params, x, cfg, moe, dtype, ckpt)
