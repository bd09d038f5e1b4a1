"""The plain reference: a GQA transformer (RMSNorm, RoPE, SwiGLU), the
capacity-dropping MoE FFN, the training loss and AdamW, in plain PyTorch.

It follows the configuration file (``bench/configs/<name>.json``) as it is
run, which records where that departs from the published model.  It reads
its weights from a flat dict of the benchmark's own leaf names
(``bench/harness/weights.py``: ``layers/attn/wq`` is (L, d, H, hd), and so
on), never from the program.  Every matrix product goes through ``mm``:
float32 with TF32 off, or, for the control, both operands rounded to
float8 e4m3 with one scale a tensor (``precision="fp8"``).  The router's
product stays float32 in both, as the configuration states it.

Memory: training checkpoints each layer (``torch.utils.checkpoint``), so
the backward holds one layer's activations at a time; serving computes
the logits of the positions asked for only.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0  # float8 e4m3's largest finite value


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
        self.moe = "num_experts" in cfg
        self.tied = bool(cfg["tie_word_embeddings"])

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

    def capacity(self, s: int) -> int:
        c = self.cfg
        cap = math.ceil(c["num_experts_per_tok"] * s * c["capacity_factor"] / c["num_experts"])
        return max(8, ((cap + 7) // 8) * 8)

    def moe_ffn(self, W, l, x):
        """Top-k routing in f32 with the gates renormalised; a (token,
        choice) pair is kept while its expert has fewer than ``capacity``
        earlier pairs in the row, counted token by token, choice by choice.
        Returns (y, the Switch load-balancing loss)."""
        c = self.cfg
        e, k = c["num_experts"], c["num_experts_per_tok"]
        b, s, d = x.shape
        probs = torch.softmax(x @ W["layers/moe/router"][l], dim=-1)
        gate, ids = torch.topk(probs, k, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True)
        first = torch.zeros(b, s, e, device=x.device).scatter_(-1, ids[..., :1], 1.0)
        aux = e * (first.mean((0, 1)) * probs.mean((0, 1))).sum()
        flat_ids = ids.reshape(b, s * k)
        onehot = torch.nn.functional.one_hot(flat_ids, e)
        before = (torch.cumsum(onehot, dim=1) - onehot).gather(-1, flat_ids[..., None])[..., 0]
        keep = (before < self.capacity(s)).reshape(b, s, k)
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
        if self.moe:
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
                   steps: int = 3) -> Dict:
    """The reference's side of a training cell's check, over ``steps``
    batches: each step's loss, each leaf's norm of the first (clipped)
    gradient, and each leaf's norm of the change of the parameters after
    the ``steps`` (``initial(name)`` makes a leaf's starting value again).
    ``W`` is updated in place."""
    for v in W.values():
        v.requires_grad_(True)
    adam = AdamW(W, opt)
    names = list(W)
    losses, grad_norms = [], None
    for i in range(steps):
        b = batches[i]
        loss = ref.loss(W, b["tokens"], b["labels"], aux_weight)
        grads = dict(zip(names, torch.autograd.grad(loss, [W[k] for k in names])))
        losses.append(float(loss.detach()))
        applied = adam.step(grads)
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in applied.items()}
        del grads, applied, loss
    for v in W.values():
        v.requires_grad_(False)
    change = {}
    for k in names:
        change[k] = float((W[k] - initial(k)).norm())
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


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
