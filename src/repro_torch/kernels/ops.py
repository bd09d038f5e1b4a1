"""Public wrappers for the port's CUDA kernels.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`
(that is what the CPU tests run).  A CUDA tensor launches the kernel or
raises: there is no fallback.  Each wrapper validates device, dtype,
shape and contiguity, allocates its output, launches on PyTorch's
current stream and checks ``cudaGetLastError``; ``LAUNCHES`` counts the
kernel launches only, so a run can prove its main path went through the
kernels, and ``ENTRY_LAUNCHES`` splits them by the C entry point that a
wrapper with two kernels routed them to.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {
    "flash_attention": 0, "flash_decode": 0, "csr_dot": 0,
    "batch_gather": 0, "batch_gather_dma": 0,
    "rglru_scan": 0, "rglru_scan_bwd": 0,
}
ENTRY_LAUNCHES: Dict[str, int] = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 160  # kMaxD in csrc/attention_tile.cuh: K4 and the tile decode kernel
_CLUSTER_HEAD_DIMS = (64, 128, 160, 256)  # csrc/flash_decode_cluster.cu's instantiations
_WIDE_ROUTE = "bf16 decode at head dim 256 runs on flash_decode's cluster kernel"
_WGMMA_HEAD_DIMS = (64, 128, 160)  # csrc/flash_attention_wgmma.cu
_WGMMA_ROWS = 64              # its query tile: the group must divide it
_MAX_GROUP = 16      # kMaxGroup in csrc/flash_decode.cu and flash_decode_cluster.cu
_DECODE_TILE = 64    # kTile in csrc/flash_decode_cluster.cu: a slice is whole tiles
_MAX_SPLITS = 8      # its largest cluster (the portable size)
_GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_MAX_TABLES = 4      # kMaxTables in csrc/batch_gather.cu: tables a batch_gather launch
_PARAM_IDS = 960     # kParamIds there: host ids a launch carries in its parameters
_MAX_GRID_Y = 65535  # the batch on grid.y (rglru_scan) or grid.z (flash_decode_cluster)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ENTRY_LAUNCHES.clear()


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


def _check_cuda(name: str, floats, heads: int, kv_heads: int, d: int,
                max_head_dim: int = _MAX_HEAD_DIM) -> int:
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
    if not (1 <= d <= max_head_dim and d % 8 == 0):
        raise ValueError(f"{name}: head dim {d} is not a multiple of 8 in 8..{_MAX_HEAD_DIM} "
                         f"({_WIDE_ROUTE})")
    return _DTYPE_CODES[next(iter(dtypes))]


def _launch(name: str, fn, *args) -> None:
    from repro_torch.kernels.build import library

    err = getattr(library(), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    ENTRY_LAUNCHES[fn] = ENTRY_LAUNCHES.get(fn, 0) + 1


def _attention_kernel(dtype: torch.dtype, d: int, group: int) -> str:
    """Which CUDA kernel serves a ``flash_attention`` call: ``"wgmma"``
    (tensor cores, ``flash_attention_wgmma.cu``) for bf16 with head dim
    64, 128 or 160 and a group ``H / K`` that divides 64; ``"cuda_core"``
    (``flash_attention.cu``) for everything else, f32 included (TF32
    products would miss its 2e-5 tolerance)."""
    if dtype == torch.bfloat16 and d in _WGMMA_HEAD_DIMS and group >= 1 \
            and _WGMMA_ROWS % group == 0:
        return "wgmma"
    return "cuda_core"


def flash_attention(q, k, v, causal: bool = True):
    """q: (B,S,H,D); k, v: (B,T,K,D) with H % K == 0.  Returns (B,S,H,D).
    Any S and T: the kernels mask the ragged edges themselves.  On the
    card, ``_attention_kernel`` picks the kernel from dtype, D and group."""
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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kh, d, int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _attention_kernel(q.dtype, d, h // kh) == "wgmma":
            _launch("flash_attention", "repro_torch_flash_attention_wgmma", *args, stream)
        else:
            _launch("flash_attention", "repro_torch_flash_attention", *args, code, stream)
    return out


def _decode_kernel(dtype: torch.dtype, d: int) -> str:
    """Which CUDA kernel serves a ``flash_decode`` call: ``"cluster"``
    (split-KV over a thread-block cluster, ``flash_decode_cluster.cu``)
    for bf16 with head dim 64, 128, 160 (stablelm-12b's) or 256
    (recurrentgemma's); ``"tile"`` (``flash_decode.cu``, head dims up to
    160) for everything else, f32 included."""
    return "cluster" if dtype == torch.bfloat16 and d in _CLUSTER_HEAD_DIMS else "tile"


def _decode_splits(b: int, kv_heads: int, t: int, sms: int) -> tuple:
    """``(splits, chunk)`` for the cluster kernel: each (row, KV head)'s
    T positions are cut into ``splits`` slices of ``chunk`` positions
    (whole 64-key tiles), one block each.  Enough splits that the
    ``B·K·splits`` blocks cover the card's ``sms`` SMs, and enough that no
    block walks more than 8 tiles where 8 splits allow; at most 8 (the
    cluster's limit) and at most one a tile."""
    tiles = -(-t // _DECODE_TILE)
    cover = -(-sms // max(1, b * kv_heads))
    n = max(1, min(_MAX_SPLITS, tiles, max(cover, -(-tiles // _MAX_SPLITS))))
    per = -(-tiles // n)
    return -(-tiles // per), per * _DECODE_TILE


def flash_decode(q, k_cache, v_cache, cur_index):
    """q: (B,H,D); caches: (B,T,K,D); cur_index: (B,) int32 >= 0.
    Attends to cache positions <= cur_index[b]; cur_index[b] >= T attends
    the whole cache.  Returns (B,H,D).  On the card, ``_decode_kernel``
    picks the kernel from dtype and D: head dim 256 only in bf16."""
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
    route = _decode_kernel(q.dtype, d)
    code = _check_cuda("flash_decode", (q, k_cache, v_cache), h, kh, d,
                       max(_CLUSTER_HEAD_DIMS) if route == "cluster" else _MAX_HEAD_DIM)
    if cur_index.dtype != torch.int32 or not cur_index.is_contiguous():
        raise TypeError("flash_decode: cur_index must be contiguous int32")
    if h // kh > _MAX_GROUP:
        raise ValueError(f"flash_decode: group {h // kh} exceeds {_MAX_GROUP}")
    if t == 0:
        raise ValueError("flash_decode: empty cache")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cur_index.data_ptr(),
            out.data_ptr(), b, t, h, kh, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "cluster":
            if b > _MAX_GRID_Y or kh > _MAX_GRID_Y:
                raise ValueError(f"flash_decode: batch {b} or {kh} KV heads exceed {_MAX_GRID_Y}")
            sms = torch.cuda.get_device_properties(q.device).multi_processor_count
            _launch("flash_decode", "repro_torch_flash_decode_cluster", *ptrs,
                    *_decode_splits(b, kh, t, sms), stream)
        else:
            _launch("flash_decode", "repro_torch_flash_decode", *ptrs, code, stream)
    return out


def csr_dot(indices, values, w, *, block_b: int = 8, gather: str = "take"):
    """Padded-CSR inner products: indices (B,K) int32 feature ids in
    [0, D), values (B,K) float32, w (D,) float32; returns (B,) float32
    ``Σ_k values[b,k]·w[indices[b,k]]``.  Pad entries are index 0 with
    value 0.0.  ``gather`` ('take' | 'onehot') and ``block_b`` keep the
    Pallas kernel's signature: both gathers are the one CUDA kernel (a
    gather is native on the card), and rows are scheduled by the kernel."""
    if gather not in ("take", "onehot"):
        raise ValueError(f"csr_dot: gather must be take|onehot, got {gather!r}")
    if block_b < 1:
        raise ValueError(f"csr_dot: block_b must be >= 1, got {block_b}")
    if indices.dim() != 2 or values.shape != indices.shape or w.dim() != 1:
        raise ValueError(
            f"csr_dot: shapes {tuple(indices.shape)}, {tuple(values.shape)}, "
            f"{tuple(w.shape)}"
        )
    if _on_cpu("csr_dot", indices, values, w):
        return ref.csr_dot(indices, values, w)
    if indices.dtype != torch.int32 or values.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(
            f"csr_dot: takes int32 indices and float32 values and w, got "
            f"{indices.dtype}, {values.dtype}, {w.dtype}"
        )
    if not (indices.is_contiguous() and values.is_contiguous() and w.is_contiguous()):
        raise ValueError("csr_dot: inputs must be contiguous")
    b, k = indices.shape
    if w.numel() == 0 and k:
        raise ValueError("csr_dot: empty weight vector")
    out = torch.empty(b, dtype=torch.float32, device=indices.device)
    if b == 0:
        return out
    with torch.cuda.device(indices.device):
        _launch(
            "csr_dot", "repro_torch_csr_dot",
            indices.data_ptr(), values.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, k, torch.cuda.current_stream().cuda_stream,
        )
    return out


def _gather_args(name, table, indices, block_d: int, rows_per_block: int):
    """Checks shared by both gathers (the Pallas wrappers' asserts, plus
    dtype); returns the indices as int32, as ``indices.astype(jnp.int32)``."""
    if table.dim() != 2 or indices.dim() != 1:
        raise ValueError(f"{name}: table (N,D) and indices (B,), got "
                         f"{tuple(table.shape)}, {tuple(indices.shape)}")
    if table.dtype not in _GATHER_DTYPES:
        raise TypeError(f"{name}: takes float32/bfloat16/int32 tables, got {table.dtype}")
    if indices.dtype.is_floating_point or indices.dtype.is_complex or indices.dtype == torch.bool:
        raise TypeError(f"{name}: indices must be integers, got {indices.dtype}")
    n, d = table.shape
    r = rows_per_block
    if r < 1 or n % r:
        raise ValueError(f"{name}: {n} rows do not split into blocks of {r}")
    bd = min(block_d, d)
    if bd < 1 or d % bd:
        raise ValueError(f"{name}: width {d} is not a multiple of block_d {bd}")
    if n == 0 and indices.numel():
        raise ValueError(f"{name}: gather from an empty table")
    return indices.to(torch.int32).contiguous()


def _gather(name, fn, table, indices, rows_per_block, *extra):
    """Launch ``batch_gather_dma`` (or the plain version on the CPU);
    ``B = 0`` returns ``(0, D)`` without a launch."""
    n, d = table.shape
    r = rows_per_block
    if _on_cpu(name, table, indices):
        return ref.batch_gather(table, indices, r)
    if not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")
    out = torch.empty(indices.shape[0] * r, d, dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        _launch(
            name, fn, table.data_ptr(), indices.data_ptr(), out.data_ptr(),
            n // r, r * d * table.element_size(), indices.shape[0], *extra,
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def _gather_route(ids_on_host: bool, b: int) -> str:
    """Which CUDA kernel serves a ``batch_gather_tables`` call of ``b`` ids:
    ``"params"`` (the ids copied into the launch's parameters,
    ``repro_torch_gather_tables_params``) for host ids with ``b <=
    _PARAM_IDS``; ``"load"`` (the kernel loads its ids from device memory,
    ``repro_torch_gather_tables``) for device ids and for more host ids,
    which are copied to the device first.  A CUDA graph that must read new
    ids at every replay needs device ids: a captured launch keeps its
    parameters."""
    return "params" if ids_on_host and b <= _PARAM_IDS else "load"


def batch_gather_tables(tables, indices, *, block_d: int = 512, rows_per_block: int = 1):
    """``[batch_gather(t, indices) for t in tables]`` in one launch: up to
    four tables (N, D) f32/bf16/int32 on one device, each with its own
    width and dtype, gathered by the same block ids.  ``indices`` may be a
    numpy array or a CPU tensor for CUDA tables: then, up to 960 ids ride
    in the launch's parameters (``_gather_route``) and no copy of them
    precedes it."""
    tables = tuple(tables)
    if not 1 <= len(tables) <= _MAX_TABLES:
        raise ValueError(f"batch_gather: 1 to {_MAX_TABLES} tables, got {len(tables)}")
    if not isinstance(indices, torch.Tensor):
        indices = torch.as_tensor(indices)
    for t in tables:  # every table's checks; the ids come back as int32
        idx = _gather_args("batch_gather", t, indices, block_d, rows_per_block)
    r, b = rows_per_block, idx.shape[0]
    devices = {t.device for t in tables}
    dev = devices.pop() if len(devices) == 1 else None
    if dev is None or idx.device not in (dev, torch.device("cpu")):
        raise ValueError(f"batch_gather: tables and ids on several devices "
                         f"{sorted(map(str, {t.device for t in tables} | {idx.device}))}")
    if dev.type == "cpu":
        return [ref.batch_gather(t, idx, r) for t in tables]
    if dev.type != "cuda":
        raise ValueError(f"batch_gather: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in tables):
        raise ValueError("batch_gather: tables must be contiguous")
    outs = [torch.empty(b * r, t.shape[1], dtype=t.dtype, device=dev) for t in tables]
    if b == 0:
        return outs
    from repro_torch.kernels.build import GatherTable

    descs = (GatherTable * len(tables))(*[
        GatherTable(t.data_ptr(), o.data_ptr(), t.shape[0] // r, r * t.shape[1] * t.element_size())
        for t, o in zip(tables, outs)])
    fn = "repro_torch_gather_tables"
    if _gather_route(idx.device.type == "cpu", b) == "params":
        fn += "_params"
    else:
        idx = idx.to(dev)
    with torch.cuda.device(dev):
        _launch("batch_gather", fn, descs, len(tables), idx.data_ptr(), b,
                torch.cuda.current_stream().cuda_stream)
    return outs


def batch_gather(table, indices, *, block_d: int = 512, rows_per_block: int = 1):
    """The LIRS gather: table (N, D) f32/bf16/int32, indices (B,) block
    ids; returns (B·r, D), block i the ``r = rows_per_block`` rows from
    ``indices[i]·r``.  Out-of-range ids follow ``ref.batch_gather`` (a
    negative id wraps once, then clamps).  ``block_d`` keeps the Pallas
    kernel's signature and its divisibility check; the CUDA kernel copies
    whole blocks.  The one-table case of ``batch_gather_tables``."""
    return batch_gather_tables((table,), indices, block_d=block_d,
                               rows_per_block=rows_per_block)[0]


def batch_gather_dma(table, indices, *, block_d: int = 512, rows_per_block: int = 1,
                     rows_per_step: int = 8):
    """``batch_gather``'s output bit for bit, ``rows_per_step`` indices per
    thread block staged through shared memory, as the Pallas kernel stages
    them through VMEM: a ring of up to 96 KB with every stage in flight at
    once (bulk copies on mbarriers where rows are 16-byte multiples and
    aligned, else ``cp.async`` or plain loads)."""
    if rows_per_step < 1:
        raise ValueError(f"batch_gather_dma: rows_per_step must be >= 1, got {rows_per_step}")
    idx = _gather_args("batch_gather_dma", table, indices, block_d, rows_per_block)
    return _gather("batch_gather_dma", "repro_torch_batch_gather_dma", table, idx,
                   rows_per_block, rows_per_step)


def _check_scan_shapes(name, *tensors) -> None:
    shape = tensors[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{name}: operands must share one (B,T,W) shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")


def _scan_kernel(*tensors: torch.Tensor) -> str:
    """Which CUDA kernel serves a scan call on these contiguous f32
    operands: ``"ring"`` (TMA ring, ``scan_ring_kernel``) where a tensor
    map can describe them — W a multiple of 4 (16-byte rows) and every
    operand 16-byte aligned; ``"lanes"`` (the thread-per-channel
    ``rglru_scan_kernel``) otherwise."""
    w = tensors[0].shape[-1]
    if w % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in tensors):
        return "ring"
    return "lanes"


def _scan_launch(name, lanes_fn, ring_fn, ins, outs):
    """Launch a scan kernel on contiguous f32 operands (the wrappers cast
    as the Pallas wrapper does) into f32 outputs: ``ring_fn`` or
    ``lanes_fn``, as ``_scan_kernel`` picks."""
    b, t, w = ins[0].shape
    if b > _MAX_GRID_Y:
        raise ValueError(f"{name}: batch {b} exceeds {_MAX_GRID_Y}")
    if outs[0].numel() == 0:
        return
    ptrs = [x.data_ptr() for x in ins + outs]
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        if _scan_kernel(*ins, *outs) == "ring":
            _launch(name, ring_fn, *ptrs, b, t, w, stream)
        else:
            _launch(name, lanes_fn, *ptrs, b, t, w, stream)


def rglru_scan(a, x):
    """The RG-LRU recurrence ``h_t = a_t·h_{t-1} + x_t`` over axis 1 from
    ``h_{-1} = 0``: a, x (B,T,W), cast to f32; returns h (B,T,W) f32."""
    _check_scan_shapes("rglru_scan", a, x)
    if _on_cpu("rglru_scan", a, x):
        return ref.rglru_scan(a, x)
    a, x = a.float().contiguous(), x.float().contiguous()
    h = torch.empty_like(x)
    _scan_launch("rglru_scan", "repro_torch_rglru_scan", "repro_torch_rglru_scan_ring",
                 [a, x], [h])
    return h


def rglru_scan_bwd(a, h, dh):
    """The scan's gradient: from the forward's ``a`` and ``h`` and the
    output gradient ``dh`` (all (B,T,W)), returns ``(dx, da)`` in f32:
    ``g_t = dh_t + a_{t+1}·g_{t+1}`` from the last step, ``dx_t = g_t``,
    ``da_t = g_t·h_{t-1}``."""
    _check_scan_shapes("rglru_scan_bwd", a, h, dh)
    if _on_cpu("rglru_scan_bwd", a, h, dh):
        return ref.rglru_scan_bwd(a, h, dh)
    a, h, dh = (t.float().contiguous() for t in (a, h, dh))
    dx, da = torch.empty_like(dh), torch.empty_like(dh)
    _scan_launch("rglru_scan_bwd", "repro_torch_rglru_scan_bwd",
                 "repro_torch_rglru_scan_ring_bwd", [a, h, dh], [dx, da])
    return dx, da


class RGLRUScan(torch.autograd.Function):
    """``rglru_scan`` under autograd: the forward saves ``a`` and ``h``,
    the backward is ``rglru_scan_bwd`` (on the card, the same kernels run
    in reverse; on the CPU, both plain versions).  Gradients come back in
    the inputs' dtypes."""

    @staticmethod
    def forward(ctx, a, x):
        h = rglru_scan(a, x)
        ctx.save_for_backward(a, h)
        ctx.x_dtype = x.dtype
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        dx, da = rglru_scan_bwd(a, h, dh)
        return da.to(a.dtype), dx.to(ctx.x_dtype)
