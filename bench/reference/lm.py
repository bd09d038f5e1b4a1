"""The plain reference: a GQA transformer (RMSNorm, RoPE, SwiGLU), the
capacity-dropping MoE FFN, the training loss and AdamW, in plain PyTorch.

It follows the configuration file (``bench/configs/<name>.json``) as it is
run, which records where that departs from the published model.  It reads
its weights from a flat dict of the benchmark's own leaf names
(``leaves``: ``layers/attn/wq`` is (L, d, H, hd), and so on), drawn by
``bench/harness/weights.py``, never from the program.  Every matrix
product goes through ``mm``: float32 with TF32 off, or, for the control,
both operands rounded to float8 e4m3 with one scale a tensor
(``precision="fp8"``).  The router's product stays float32 in both, as the
configuration states it.

A MoE layer routes by its own top k, or, where ``Ref.forced`` holds the
step's routes, by those (the program's, or the control's): the gates, the
capacity drops and the load-balancing loss are then the reference's own
arithmetic at those ids, and the layer counts the forced (token, choice)
pairs that its own probabilities rank outside its top k by more than
``ROUTE_DELTA`` (``route_gap``).

This is the default reference module of a configuration file (its
``"reference"`` key names another, ``bench/reference/<name>.py``).  What
the harness takes from such a module: ``leaves``, ``port_path`` and
``port_widths`` (the weights, where the program holds them, and the widths
``harness.spec.port_config`` checks), ``full_f32``, ``Ref``,
``moe_layers``, ``train_readings`` and ``served_gaps``.

Memory: training checkpoints each layer (``torch.utils.checkpoint``), so
the backward holds one layer's activations at a time; serving computes
the logits of the positions asked for only.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0  # float8 e4m3's largest finite value
# A forced (token, choice) pair counts against ``route_gap`` where the
# reference's probability of its expert lies below (1 - ROUTE_DELTA) times
# the reference's own k-th largest: a near tie is no fault.  The program
# rounds the router's input to bfloat16 (a relative error up to 2**-9 an
# element) after bf16 products in every layer before it; with router
# logits of unit scale that moves a logit, and so the ratio of two
# probabilities, by some 1e-3 to 1e-2.  1/32 is 16 times bf16's 2**-9 and
# half of float8 e4m3's 2**-4 (PERF.md §2 has route_gap read at it).
ROUTE_DELTA = 1.0 / 32


# ----------------------------------------------------- leaves and widths

Leaf = Tuple[str, Tuple[int, ...], float]


def leaves(cfg: Dict) -> List[Leaf]:
    """``(name, shape, scale)`` of every leaf of a configuration file's
    model, in the benchmark's naming.  Matrices are drawn at
    1/sqrt(fan-in); the embedding's rows at 0.02; the norm scales (read as
    ``1 + scale``) at 0.1.  A configuration with tied embeddings has no
    ``lm_head``: its logits are the embedding's transpose."""
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    n, v = cfg["num_hidden_layers"], cfg["vocab_size"]
    out: List[Leaf] = [("embed", (v, d), 0.02), ("final_norm", (d,), 0.1)]
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", (d, v), d ** -0.5))
    out += [
        ("layers/norm1", (n, d), 0.1),
        ("layers/norm2", (n, d), 0.1),
        ("layers/attn/wq", (n, d, h, hd), d ** -0.5),
        ("layers/attn/wk", (n, d, kv, hd), d ** -0.5),
        ("layers/attn/wv", (n, d, kv, hd), d ** -0.5),
        ("layers/attn/wo", (n, h, hd, d), (h * hd) ** -0.5),
    ]
    if "num_experts" not in cfg:
        f = cfg["intermediate_size"]
        return out + [("layers/ffn/w_in", (n, d, f), d ** -0.5),
                      ("layers/ffn/w_gate", (n, d, f), d ** -0.5),
                      ("layers/ffn/w_out", (n, f, d), f ** -0.5)]
    e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    routed = cfg.get("published", {}).get("num_experts", e)
    if e != routed:
        raise ValueError(f"{cfg['name']}: this reference holds every expert ({routed}), the file "
                         f"{e}; a chip's share takes a reference module of its own")
    out += [("layers/moe/router", (n, d, e), d ** -0.5),
            ("layers/moe/w_in", (n, e, d, f), d ** -0.5),
            ("layers/moe/w_gate", (n, e, d, f), d ** -0.5),
            ("layers/moe/w_out", (n, e, f, d), f ** -0.5)]
    if "shared_expert_intermediate_size" in cfg:
        fs = cfg["shared_expert_intermediate_size"]
        out += [("layers/shared/w_in", (n, d, fs), d ** -0.5),
                ("layers/shared/w_gate", (n, d, fs), d ** -0.5),
                ("layers/shared/w_out", (n, fs, d), fs ** -0.5)]
    return out


_PORT_NAMES = {"layers/moe/router": "moe/router", "layers/moe/w_in": "moe/w_in",
               "layers/moe/w_gate": "moe/w_gate", "layers/moe/w_out": "moe/w_out",
               "layers/shared/w_in": "moe/shared/w_in", "layers/shared/w_gate": "moe/shared/w_gate",
               "layers/shared/w_out": "moe/shared/w_out"}


def port_path(name: str) -> str:
    """The path of a leaf in the program's parameter tree (one stage of
    one block kind): ``layers/...`` lives at ``stages/0/0/...``."""
    if not name.startswith("layers/"):
        return name
    return "stages/0/0/" + _PORT_NAMES.get(name, name[len("layers/"):])


def port_widths(cfg: Dict) -> Dict[str, str]:
    """The file's keys that must equal the program's configuration, each
    with the attribute of the port's ``ModelConfig`` that holds it."""
    have = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
            "num_key_value_heads": "num_kv_heads", "head_dim": "kq_dim",
            "vocab_size": "vocab_size", "tie_word_embeddings": "tie_embeddings"}
    if "num_experts" not in cfg:
        return dict(have, intermediate_size="d_ff")
    return dict(have, num_experts="moe.num_experts", num_experts_per_tok="moe.experts_per_token",
                moe_intermediate_size="moe.d_ff_expert", capacity_factor="moe.capacity_factor",
                shared_expert_intermediate_size="moe.d_ff_shared")


def moe_layers(cfg: Dict) -> List[int]:
    """The layers that route, in order: every layer of a configuration
    with experts, none of a dense one.  The harness keeps one routing a
    step for each, and forces layer ``l`` by the routing kept for it."""
    return list(range(cfg["num_hidden_layers"])) if "num_experts" in cfg else []


def full_f32() -> None:
    """Pin float32 products to float32 (no TF32) on every backend."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to e4m3's largest value, returned in float32."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _RoundFP8(torch.autograd.Function):
    """fp8 rounding with a straight-through gradient (the control's
    backward products round their operands again in ``mm``)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class Ref:
    """One configuration's reference.  ``cfg`` is the configuration file's
    dict; ``precision`` is ``"f32"`` or ``"fp8"`` (the control)."""

    def __init__(self, cfg: Dict, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.cfg = cfg
        self.precision = precision
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        self.layers = cfg["num_hidden_layers"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.routed = set(moe_layers(cfg))
        self.moe = bool(self.routed)
        self.tied = bool(cfg["tie_word_embeddings"])
        # MoE routing of the step under way, by layer: ``forced`` (set by the
        # caller) the ids to route by, a dict by layer, else None; ``chosen`` the layer's own
        # top k where nothing is forced; ``outside`` and ``pairs`` the forced
        # pairs ranked outside the reference's top k by more than
        # ROUTE_DELTA, and all of them (a checkpointed layer's recompute
        # writes the same again)
        self.forced: Optional[Dict[int, torch.Tensor]] = None
        self.chosen: Dict[int, torch.Tensor] = {}
        self.outside: Dict[int, int] = {}
        self.pairs: Dict[int, int] = {}

    # ------------------------------------------------------------ pieces
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = _RoundFP8.apply(a), _RoundFP8.apply(b)
        return a @ b

    def norm(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * (1.0 + scale)

    def rope(self, x, pos):
        """Rotate the two halves of each head by ``pos`` × θ^(-i/half)."""
        half = self.hd // 2
        inv = 1.0 / (self.theta ** (torch.arange(half, dtype=torch.float64) / half))
        ang = (pos.to(torch.float64)[:, None] * inv.to(pos.device)[None]).float()
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, W, l, x, pos):
        b, s, _ = x.shape
        h, kv, hd = self.h, self.kv, self.hd
        q = self.mm(x, W["layers/attn/wq"][l].reshape(self.d, h * hd)).view(b, s, h, hd)
        k = self.mm(x, W["layers/attn/wk"][l].reshape(self.d, kv * hd)).view(b, s, kv, hd)
        v = self.mm(x, W["layers/attn/wv"][l].reshape(self.d, kv * hd)).view(b, s, kv, hd)
        q, k = self.rope(q, pos), self.rope(k, pos)
        g = h // kv  # query head j reads kv head j // g
        q = q.permute(0, 2, 1, 3).reshape(b, kv, g * s, hd)
        k, v = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        scores = self.mm(q, k.transpose(-1, -2)).view(b, kv, g, s, s) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        o = self.mm(p.view(b, kv, g * s, s), v).view(b, kv, g, s, hd)
        o = o.permute(0, 3, 1, 2, 4).reshape(b, s, h * hd)
        return self.mm(o, W["layers/attn/wo"][l].reshape(h * hd, self.d))

    def head(self, W):
        """The output projection (d, V): the embedding's transpose where
        the configuration ties them."""
        return W["embed"].T if self.tied else W["lm_head"]

    def swiglu(self, x, w_in, w_gate, w_out):
        return self.mm(torch.nn.functional.silu(self.mm(x, w_gate)) * self.mm(x, w_in), w_out)

    def capacity(self, s: int) -> Optional[int]:
        """Slots an expert has in a row of ``s`` tokens; None where the file
        states no ``capacity_factor`` (nothing is dropped)."""
        c = self.cfg
        if "capacity_factor" not in c:
            return None
        cap = math.ceil(c["num_experts_per_tok"] * s * c["capacity_factor"] / c["num_experts"])
        return max(8, ((cap + 7) // 8) * 8)

    def route(self, l: int, probs: torch.Tensor) -> torch.Tensor:
        """The (B, S, k) expert ids layer ``l`` routes by: the forced ones
        where there are any (counting those outside its own top k by more
        than ROUTE_DELTA), else its own top k, sorted descending."""
        k = self.cfg["num_experts_per_tok"]
        top = torch.topk(probs.detach(), k, dim=-1)
        forced = self.forced[l] if self.forced is not None else None
        if forced is None:
            self.chosen[l] = top.indices
            return top.indices
        ids = forced.to(probs.device).reshape(top.indices.shape)
        at = probs.detach().gather(-1, ids)
        self.outside[l] = int((at < top.values[..., -1:] * (1.0 - ROUTE_DELTA)).sum())
        self.pairs[l] = ids.numel()
        return ids

    def moe_ffn(self, W, l, x):
        """Routing in f32 (``route``), the gates the softmax's at the ids,
        renormalised where the file's ``norm_topk_prob`` says so; a (token,
        choice) pair is kept while its expert has fewer than ``capacity``
        earlier pairs in the row, counted token by token, choice by choice,
        in the order of the ids.  Returns (y, the Switch load-balancing
        loss: E × Σ over the experts of the first choices' density times the
        mean probability)."""
        c = self.cfg
        e, k = c["num_experts"], c["num_experts_per_tok"]
        b, s, d = x.shape
        probs = torch.softmax(x @ W["layers/moe/router"][l], dim=-1)
        ids = self.route(l, probs)
        gate = probs.gather(-1, ids)
        if c.get("norm_topk_prob", False):
            gate = gate / gate.sum(-1, keepdim=True)
        first = torch.zeros(b, s, e, device=x.device).scatter_(-1, ids[..., :1], 1.0)
        aux = e * (first.mean((0, 1)) * probs.mean((0, 1))).sum()
        cap = self.capacity(s)
        if cap is None:
            keep = torch.ones_like(ids, dtype=torch.bool)
        else:
            flat_ids = ids.reshape(b, s * k)
            onehot = torch.nn.functional.one_hot(flat_ids, e)
            before = (torch.cumsum(onehot, dim=1) - onehot).gather(-1, flat_ids[..., None])[..., 0]
            keep = (before < cap).reshape(b, s, k)
        xf, y = x.reshape(b * s, d), torch.zeros(b * s, d, device=x.device)
        ids_f, gate_f, keep_f = ids.reshape(b * s, k), gate.reshape(b * s, k), keep.reshape(b * s, k)
        for ex in range(e):
            tok, choice = torch.nonzero((ids_f == ex) & keep_f, as_tuple=True)
            if tok.numel() == 0:
                continue
            out = self.swiglu(xf[tok], W["layers/moe/w_in"][l, ex], W["layers/moe/w_gate"][l, ex],
                              W["layers/moe/w_out"][l, ex])
            y = y.index_add(0, tok, out * gate_f[tok, choice][:, None])
        y = y.reshape(b, s, d)
        if "shared_expert_intermediate_size" in c:
            y = y + self.swiglu(x, W["layers/shared/w_in"][l], W["layers/shared/w_gate"][l],
                                W["layers/shared/w_out"][l])
        return y, aux

    def layer(self, W, l, x, pos):
        x = x + self.attention(W, l, self.norm(x, W["layers/norm1"][l]), pos)
        h = self.norm(x, W["layers/norm2"][l])
        if l in self.routed:
            y, aux = self.moe_ffn(W, l, h)
            return x + y, aux
        y = self.swiglu(h, W["layers/ffn/w_in"][l], W["layers/ffn/w_gate"][l],
                        W["layers/ffn/w_out"][l])
        return x + y, torch.zeros((), device=x.device)

    def hidden(self, W, tokens, remat: bool):
        """Final-normed hidden states (B, S, d) and the summed aux loss."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = W["embed"][tokens]
        aux = torch.zeros((), device=tokens.device)
        for l in range(self.layers):
            if remat:
                x, a = checkpoint(self.layer, W, l, x, pos, use_reentrant=False)
            else:
                x, a = self.layer(W, l, x, pos)
            aux = aux + a
        return self.norm(x, W["final_norm"]), aux

    # ------------------------------------------------------------ entry
    def loss(self, W, tokens, labels, aux_weight: float):
        """Mean next-token cross-entropy over the positions ``labels``
        covers (its leading ones), plus ``aux_weight`` × the MoE
        load-balancing losses summed over layers."""
        h, aux = self.hidden(W, tokens, remat=True)
        logits = self.mm(h[:, :labels.shape[1]], self.head(W))
        nll = -torch.log_softmax(logits, -1).gather(-1, labels[..., None].long())[..., 0]
        return nll.mean() + aux_weight * aux

    @torch.no_grad()
    def logits_at(self, W, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Logits (len(positions), V) of one sequence (1, S) at ``positions``."""
        h, _ = self.hidden(W, tokens, remat=False)
        return self.mm(h[0, positions], self.head(W))


class AdamW:
    """AdamW as the configuration runs it: the global gradient norm clipped
    to ``grad_clip``; the learning rate warmed up linearly over
    ``warmup_steps`` (``lr × min(1, (t + 1) / warmup)`` at step t from 0);
    bias-corrected moments; decoupled weight decay scaled by the rate."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: Dict):
        self.p, self.o = params, opt
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update in place; returns the clipped gradients it applied."""
        o = self.o
        lr = o["lr"] * min(1.0, (self.t + 1) / max(1, o["warmup_steps"]))
        self.t += 1
        bc1, bc2 = 1.0 - o["b1"] ** self.t, 1.0 - o["b2"] ** self.t
        gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        scale = torch.where(gnorm > o["grad_clip"], o["grad_clip"] / gnorm, torch.ones_like(gnorm))
        applied = {}
        for k, p in self.p.items():
            g = grads[k] * scale
            applied[k] = g
            self.mu[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.nu[k].mul_(o["b2"]).add_(g.square(), alpha=1 - o["b2"])
            upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + o["eps"])
            p.sub_(lr * (upd + o["weight_decay"] * p))
        return applied


def train_readings(ref: Ref, W: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
                   opt: Dict, aux_weight: float, initial: Callable[[str], torch.Tensor],
                   steps: int = 3, routes: Optional[List[Dict[int, torch.Tensor]]] = None) -> Dict:
    """The reference's side of a training cell's check, over ``steps``
    batches: each step's loss, each leaf's norm of the first (clipped)
    gradient, and each leaf's norm of the change of the parameters after
    the ``steps`` (``initial(name)`` makes a leaf's starting value again).
    ``W`` is updated in place.

    A MoE configuration routes step i by ``routes[i]`` (a (B, S, k) ids
    tensor for each layer of ``moe_layers``, by layer) where they are
    given, and then also returns ``route_outside`` and ``route_pairs``
    (``Ref.route``'s counts over the steps); else it returns the routes it
    took itself, as ``routes``."""
    for v in W.values():
        v.requires_grad_(True)
    adam = AdamW(W, opt)
    names = list(W)
    losses, grad_norms, taken, outside, pairs = [], None, [], 0, 0
    for i in range(steps):
        b = batches[i]
        ref.forced, ref.chosen, ref.outside, ref.pairs = (routes[i] if routes else None), {}, {}, {}
        loss = ref.loss(W, b["tokens"], b["labels"], aux_weight)
        grads = dict(zip(names, torch.autograd.grad(loss, [W[k] for k in names])))
        losses.append(float(loss.detach()))
        taken.append(dict(ref.chosen))
        outside, pairs = outside + sum(ref.outside.values()), pairs + sum(ref.pairs.values())
        applied = adam.step(grads)
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in applied.items()}
        del grads, applied, loss
    ref.forced, ref.chosen = None, {}
    for v in W.values():
        v.requires_grad_(False)
    change = {}
    for k in names:
        change[k] = float((W[k] - initial(k)).norm())
    out = {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
    if ref.moe and routes:
        out.update(route_outside=outside, route_pairs=pairs)
    elif ref.moe:
        out["routes"] = taken
    return out


def served_gaps(ref: Ref, W, prompt: torch.Tensor, served: torch.Tensor,
                control: Optional[Ref] = None) -> torch.Tensor:
    """For one request, the gap at each served token's position between the
    reference's largest logit and its logit of the token served.  With a
    ``control``, the token is the one the control puts first instead."""
    seq = torch.cat([prompt, served[:-1]])[None]
    positions = torch.arange(len(prompt) - 1, seq.shape[1], device=seq.device)
    logits = ref.logits_at(W, seq, positions)
    chosen = served if control is None else control.logits_at(W, seq, positions).argmax(-1)
    return logits.max(-1).values - logits.gather(-1, chosen[:, None].long())[:, 0]
