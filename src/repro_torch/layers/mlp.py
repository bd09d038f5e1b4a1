"""Feed-forward blocks: SwiGLU / GeGLU / plain GeLU.

Weights are stored in the storage dtype (f32) and cast to the compute
dtype at each use (``common.cast``), as in the JAX package.  With
``ckpt`` the activation between the products is a remat segment
(``common.segment``).
"""
from __future__ import annotations

import torch

from repro_torch.layers.common import activation_fn, cast, dense_init, segment


def init_ffn(generator, d_model: int, d_ff: int, activation: str, dtype, device):
    p = {
        "w_in": dense_init((d_model, d_ff), dtype, generator, device),
        "w_out": dense_init((d_ff, d_model), dtype, generator, device),
    }
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init((d_model, d_ff), dtype, generator, device)
    return p


def gated(act, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return act(g) * h


def apply_ffn(params, x: torch.Tensor, activation: str, dtype, ckpt: bool = False) -> torch.Tensor:
    act = activation_fn(activation)
    h = x @ cast(params["w_in"], dtype)
    if "w_gate" in params:
        h = segment(ckpt, gated, act, x @ cast(params["w_gate"], dtype), h)
    else:
        h = segment(ckpt, act, h)
    return h @ cast(params["w_out"], dtype)
