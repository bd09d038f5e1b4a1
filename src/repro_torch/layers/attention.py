"""Grouped-query attention: projections, full causal prefill attention and
single-token decode attention.

Shapes follow the JAX package: q (B,S,H,D); k/v (B,T,K,D); H = K·G.
``full_attention`` and ``decode_attention`` dispatch to the port's
kernels (:mod:`repro_torch.kernels.ops`): the CUDA kernels for tensors on
the card, their plain versions for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.layers.common import dense_init


def init_attn(generator, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, dtype, device):
    return {
        "wq": dense_init((d_model, num_heads, head_dim), dtype, generator, device),
        "wk": dense_init((d_model, num_kv_heads, head_dim), dtype, generator, device),
        "wv": dense_init((d_model, num_kv_heads, head_dim), dtype, generator, device),
        "wo": dense_init((num_heads, head_dim, d_model), dtype, generator, device),
    }


def _project(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(dtype)).unflatten(-1, (h, k))


def qkv(params, x: torch.Tensor, dtype):
    return (
        _project(x, params["wq"], dtype),
        _project(x, params["wk"], dtype),
        _project(x, params["wv"], dtype),
    )


def out_proj(params, o: torch.Tensor, dtype) -> torch.Tensor:
    """einsum('bshk,hkd->bsd')."""
    h, k, d = params["wo"].shape
    return o.flatten(-2) @ params["wo"].reshape(h * k, d).to(dtype)


def full_attention(q, k, v, causal: bool = True):
    return ops.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, cur_index):
    """q: (B,1,H,D); caches: (B,T,K,D); attends to positions <= cur_index."""
    return ops.flash_decode(q[:, 0], k_cache, v_cache, cur_index)[:, None]
