"""Griffin-style gated linear recurrent unit (RG-LRU) block.

    r_t = sigmoid(W_a u_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x u_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

The full-sequence path of the JAX layer (``repro.layers.rglru``), with the
recurrence on the port's scan kernel (``ops.RGLRUScan``: the CUDA kernel
forward and in reverse for the gradient on the card, the plain loops on
the CPU) where JAX runs ``jax.lax.associative_scan``.  The single-token
decode step (``apply_rglru_step``) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.layers.common import activation_fn, dense_init

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
    ub = u.to(dt).reshape(b, s, h, width // h)
    return torch.einsum("bshw,hwv->bshv", ub, w.to(dt)).reshape(b, s, width)


def _causal_conv(u: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor, history=None):
    """Depthwise causal conv along time.  u: (B,S,W); conv_w: (CW, W).
    Returns the output and the trailing ``CW - 1`` inputs."""
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


def _gates(params, u: torch.Tensor):
    """The decay ``a`` and the gated input ``b``, both f32."""
    r = torch.sigmoid(_block_diag(u, params["wa"]) + params["ba"])
    i = torch.sigmoid(_block_diag(u, params["wi"]) + params["bi"])
    log_a = (-C_CONST * F.softplus(params["lam"].float())) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i.float() * u.float())


def apply_rglru(params, x: torch.Tensor, dtype, h0=None, conv_hist=None):
    """x: (B,S,d) -> (y, (h_last, conv_hist)).  Full-sequence path; the
    carried state ``h_last`` stays f32."""
    u = x @ params["wx"].to(dtype)
    g = activation_fn("gelu")(x @ params["wg"].to(dtype))
    u, hist = _causal_conv(u, params["conv_w"].to(dtype), params["conv_b"].to(dtype), conv_hist)
    a, b = _gates(params, u)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    h = ops.RGLRUScan.apply(a, b)
    y = (h.to(dtype) * g) @ params["wo"].to(dtype)
    return y, (h[:, -1], hist)
