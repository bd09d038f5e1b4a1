"""Griffin-style gated linear recurrent unit (RG-LRU) block.

    r_t = sigmoid(W_a u_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x u_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

The full-sequence path of the JAX layer (``repro.layers.rglru``), with the
recurrence on the port's scan kernel (``ops.RGLRUScan``: the CUDA kernel
forward and in reverse for the gradient on the card, the plain loops on
the CPU) where JAX runs ``jax.lax.associative_scan``; and the
single-token decode step (``apply_rglru_step``), plain torch as JAX
computes it in jnp: one step needs no scan.  With ``ckpt`` the conv, and
the gates with the scan and the output gate, are remat segments
(``common.segment``) between the products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.layers.common import activation_fn, cast, dense_init, replicate_dims, segment

C_CONST = 8.0


def init_rglru(generator, d_model: int, width: int, conv_width: int, dtype, device,
               num_heads: int = 1):
    """Gate projections are block-diagonal over ``num_heads`` blocks, as in
    Griffin; Λ is drawn so that a ∈ ~(0.9, 0.999) at r = 0.5."""
    hb = width // num_heads
    lam = torch.empty((width,), dtype=torch.float32, device=device)
    lam.uniform_(0.3, 0.8, generator=generator)
    return {
        "wx": dense_init((d_model, width), dtype, generator, device),
        "wg": dense_init((d_model, width), dtype, generator, device),
        "conv_w": dense_init((conv_width, width), dtype, generator, device, scale=0.1),
        "conv_b": torch.zeros((width,), dtype=dtype, device=device),
        "wa": dense_init((num_heads, hb, hb), dtype, generator, device),
        "ba": torch.zeros((width,), dtype=dtype, device=device),
        "wi": dense_init((num_heads, hb, hb), dtype, generator, device),
        "bi": torch.zeros((width,), dtype=dtype, device=device),
        "lam": lam.to(dtype),
        "wo": dense_init((width, d_model), dtype, generator, device),
    }


def _block_diag(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (B,S,W); w: (H, W/H, W/H) block-diagonal projection, in the
    promoted dtype of the two (jnp.einsum promotes; torch's refuses mixed
    dtypes)."""
    b, s, width = u.shape
    h = w.shape[0]
    dt = torch.promote_types(u.dtype, w.dtype)
    # a DTensor's width is made whole: its head split has no sharding rule
    # where the heads do not divide the mesh dim
    ub = replicate_dims(replicate_dims(u, 2).to(dt).reshape(b, s, h, width // h), 2, 3)
    out = torch.einsum("bshw,hwv->bshv", ub, cast(w, dt))
    return replicate_dims(replicate_dims(out, 2, 3).reshape(b, s, width), 2)


def _causal_conv(u: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor, dtype,
                 history=None):
    """Depthwise causal conv along time.  u: (B,S,W); conv_w: (CW, W),
    taken in ``dtype``.  Returns the output and the trailing ``CW - 1``
    inputs."""
    conv_w, conv_b = cast(conv_w, dtype), cast(conv_b, dtype)
    cw = conv_w.shape[0]
    if history is None:
        pad = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    else:
        pad = history  # (B, cw-1, W) trailing inputs from a previous segment
    full = torch.cat([pad, u], dim=1)
    out = torch.zeros_like(u)
    for i in range(cw):  # taps reversed, as the JAX layer applies them
        out = out + full[:, i : i + u.shape[1]] * conv_w[cw - 1 - i][None, None, :]
    return out + conv_b[None, None, :], full[:, -(cw - 1):]


def _gates(ra, ri, u, ba, bi, lam):
    """The decay ``a`` and the gated input ``b``, both f32, from the
    gates' block-diagonal products ``ra`` and ``ri``."""
    r = torch.sigmoid(ra + ba)
    i = torch.sigmoid(ri + bi)
    log_a = (-C_CONST * F.softplus(lam.float())) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i.float() * u.float())


def _gate_products(params, u):
    return _block_diag(u, params["wa"]), _block_diag(u, params["wi"])


def _scan(ra, ri, u, g, ba, bi, lam, h0, dtype):
    """The gates, the recurrence and the output gate: ``(h·gelu(g),
    h_last)``."""
    a, b = _gates(ra, ri, u, ba, bi, lam)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    h = ops.RGLRUScan.apply(a, b)
    return h.to(dtype) * activation_fn("gelu")(g), h[:, -1]


def apply_rglru(params, x: torch.Tensor, dtype, h0=None, conv_hist=None, ckpt: bool = False):
    """x: (B,S,d) -> (y, (h_last, conv_hist)).  Full-sequence path; the
    carried state ``h_last`` stays f32."""
    # DTensor: the products' partial sums reduced here, as JAX lays the
    # recurrent block out (no split over ``model``); reduced where the
    # gates read them, they went onto a split of S beside B's (the 3-dim
    # mesh), a strided split that DTensor's planner takes minutes to lay out
    u = replicate_dims(x @ cast(params["wx"], dtype), 1, 2)
    g = replicate_dims(x @ cast(params["wg"], dtype), 1, 2)
    u, hist = segment(ckpt, _causal_conv, u, params["conv_w"], params["conv_b"], dtype, conv_hist)
    ra, ri = _gate_products(params, u)
    y, h_last = segment(ckpt, _scan, ra, ri, u, g, params["ba"], params["bi"], params["lam"],
                        h0, dtype)
    return y @ cast(params["wo"], dtype), (h_last, hist)


def apply_rglru_step(params, x: torch.Tensor, state, dtype):
    """Single decode step.  x: (B,1,d); state = (h_prev (B,W) f32,
    conv_hist (B,CW-1,W)).  Returns (y (B,1,d), (h, conv_hist))."""
    h_prev, conv_hist = state
    u = replicate_dims(x @ cast(params["wx"], dtype), 1, 2)  # as ``apply_rglru``'s
    g = activation_fn("gelu")(replicate_dims(x @ cast(params["wg"], dtype), 1, 2))
    u, hist = _causal_conv(u, params["conv_w"], params["conv_b"], dtype, conv_hist)
    a, b = _gates(*_gate_products(params, u), u, params["ba"], params["bi"], params["lam"])
    h = a[:, 0] * h_prev.float() + b[:, 0]  # the carried state stays f32
    y = (h.to(dtype) * g[:, 0]) @ cast(params["wo"], dtype)
    return y[:, None], (h, hist)
