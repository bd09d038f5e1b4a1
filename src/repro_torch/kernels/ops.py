"""Public wrappers for the port's CUDA kernels.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`
(that is what the CPU tests run).  A CUDA tensor launches the kernel or
raises: there is no fallback.  Each wrapper validates device, dtype,
shape and contiguity, allocates its output, launches on PyTorch's
current stream and checks ``cudaGetLastError``; ``LAUNCHES`` counts the
kernel launches only, so a run can prove its main path went through the
kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_decode": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128  # kMaxD in csrc/attention_tile.cuh
_MAX_GROUP = 16      # kMaxGroup in csrc/flash_decode.cu


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return False


def _check_cuda(name: str, floats, heads: int, kv_heads: int, d: int) -> int:
    dtypes = {t.dtype for t in floats}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODES:
        raise TypeError(f"{name}: takes one dtype of float32/bfloat16, got {dtypes}")
    for t in floats:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:  # the kernels move 16-byte vectors
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    if kv_heads < 1 or heads % kv_heads:
        raise ValueError(f"{name}: {heads} heads do not group over {kv_heads} KV heads")
    if not (1 <= d <= _MAX_HEAD_DIM and d % 8 == 0):
        raise ValueError(f"{name}: head dim {d} is not a multiple of 8 in 8..{_MAX_HEAD_DIM}")
    return _DTYPE_CODES[next(iter(dtypes))]


def _launch(name: str, fn, *args) -> None:
    from repro_torch.kernels.build import library

    err = getattr(library(), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def flash_attention(q, k, v, causal: bool = True):
    """q: (B,S,H,D); k, v: (B,T,K,D) with H % K == 0.  Returns (B,S,H,D).
    Any S and T: the kernel masks the ragged edges itself."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {q.shape}, {k.shape}, {v.shape}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if _on_cpu("flash_attention", q, k, v):
        return ref.flash_attention(q, k, v, causal)
    code = _check_cuda("flash_attention", (q, k, v), h, kh, d)
    if t == 0:
        raise ValueError("flash_attention: no keys")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _launch(
            "flash_attention", "repro_torch_flash_attention",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kh, d, int(bool(causal)), code,
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def flash_decode(q, k_cache, v_cache, cur_index):
    """q: (B,H,D); caches: (B,T,K,D); cur_index: (B,) int32 >= 0.
    Attends to cache positions <= cur_index[b]; cur_index[b] >= T attends
    the whole cache.  Returns (B,H,D)."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"flash_decode: shapes {q.shape}, {k_cache.shape}, {v_cache.shape}"
        )
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or cur_index.shape != (b,):
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"cur {tuple(cur_index.shape)}"
        )
    if _on_cpu("flash_decode", q, k_cache, v_cache, cur_index):
        return ref.flash_decode(q, k_cache, v_cache, cur_index)
    code = _check_cuda("flash_decode", (q, k_cache, v_cache), h, kh, d)
    if cur_index.dtype != torch.int32 or not cur_index.is_contiguous():
        raise TypeError("flash_decode: cur_index must be contiguous int32")
    if h // kh > _MAX_GROUP:
        raise ValueError(f"flash_decode: group {h // kh} exceeds {_MAX_GROUP}")
    if t == 0:
        raise ValueError("flash_decode: empty cache")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _launch(
            "flash_decode", "repro_torch_flash_decode",
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cur_index.data_ptr(), out.data_ptr(), b, t, h, kh, d, code,
            torch.cuda.current_stream().cuda_stream,
        )
    return out
