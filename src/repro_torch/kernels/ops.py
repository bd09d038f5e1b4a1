"""Public wrappers for the port's CUDA kernels.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`
(that is what the CPU tests run).  A CUDA tensor launches the kernel or
raises: there is no fallback.  Each wrapper validates device, dtype,
shape and contiguity, allocates its output, launches on PyTorch's
current stream and checks ``cudaGetLastError``; ``LAUNCHES`` counts the
kernel launches only, so a run can prove its main path went through the
kernels, and ``ENTRY_LAUNCHES`` splits them by the C entry point that a
wrapper with two kernels routed them to.

A DTensor (a tensor laid out on a device mesh, :mod:`repro_torch.
sharding.specs`) reaches K4, K5 and K6 through ``local_shards``: the
inputs are redistributed to the kernel's layout (``_kernel_placements``:
the batch split over the data dims, heads or width over ``model`` where
they divide it, every other dim whole) and the kernel runs on each
rank's local shards, launching as above on the card; ``LAUNCHES`` counts
those local launches.  A decode cache whose positions are split over
``model`` (``cache_pspecs``) stays split: K6 runs on each rank's slice
of positions and the partial outputs are combined by their log-sum-exps.

The training path's causal attention on the card is ``CausalAttention``:
``flash_attention_train`` (K4's tensor-core kernel with a log-sum-exp
epilogue) and ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``),
routed by ``train_attention_route``; off the card it keeps the masked
``sdpa``, so neither has a meta path.

On the meta device (the dry run) K4, K5 and K6 run as the custom ops
``torch.ops.repro_torch.*``, whose fake implementations give outputs of
the right shape and dtype and compute nothing, and whose FLOPs are in
``torch.utils.flop_counter``'s registry.  The card and the CPU call the
wrappers directly: a custom op's dispatch costs about 20 µs of host time
a call, more than a decode kernel takes.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {
    "flash_attention": 0, "flash_decode": 0, "csr_dot": 0,
    "batch_gather": 0, "batch_gather_dma": 0,
    "rglru_scan": 0, "rglru_scan_bwd": 0,
    "flash_attention_train": 0, "flash_attention_bwd": 0,
}
ENTRY_LAUNCHES: Dict[str, int] = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 160  # kMaxD in csrc/attention_tile.cuh: K4 and the tile decode kernel
_CLUSTER_HEAD_DIMS = (64, 128, 160, 256)  # csrc/flash_decode_cluster.cu's instantiations
_WIDE_ROUTE = "bf16 decode at head dim 256 runs on flash_decode's cluster kernel"
_WGMMA_HEAD_DIMS = (64, 128, 160)  # csrc/flash_attention_wgmma.cu
_WGMMA_ROWS = 64              # its query tile: the group must divide it
_TRAIN_HEAD_DIMS = (64, 128)  # csrc/flash_attention_bwd.cu (and the training forward)
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


def _device_type(name: str, *tensors: torch.Tensor) -> str:
    """``"cpu"`` (the plain version), ``"cuda"`` (the kernel) or
    ``"meta"`` (shapes only) for plain tensors on one device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """The route of a wrapper with no meta path: the plain version on the
    CPU, else the kernel on the card."""
    where = _device_type(name, *tensors)
    if where == "meta":
        raise ValueError(f"{name}: no kernel for device meta")
    return where == "cpu"


# ------------------------------------------------------------ DTensor


def _is_dtensor(*tensors) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in tensors)


def _kernel_placements(mesh, batch: int, split_dim, splits: tuple, batch_dim: int = 0) -> tuple:
    """One operand's placements for a kernel on local shards: dim
    ``batch_dim`` (the batch, of ``batch`` rows; None: none) ``Shard`` on
    the data dims (``pod``, ``data``) when it divides them, dim
    ``split_dim`` ``Shard`` on ``model`` when every size in ``splits``
    divides it (``split_dim`` None: never), everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = tuple(mesh.mesh_dim_names or ()), tuple(mesh.shape)
    out = [Replicate()] * len(names)
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    dp_size = 1
    for i in dp:
        dp_size *= sizes[i]
    if dp and batch_dim is not None and batch % dp_size == 0:
        for i in dp:
            out[i] = Shard(batch_dim)
    if split_dim is not None and "model" in names:
        m = names.index("model")
        if all(n % sizes[m] == 0 for n in splits):
            out[m] = Shard(split_dim)
    # a mesh dim of size 1 splits nothing: Replicate, the same layout
    return tuple(Replicate() if sizes[i] == 1 else p for i, p in enumerate(out))


def _as_dtensor(x, mesh):
    """A plain tensor as a DTensor replicated on ``mesh`` (a constant made
    inside the model meets a laid-out operand)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor) or not isinstance(x, torch.Tensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _mesh_of(*tensors):
    from torch.distributed.tensor import DTensor

    return next(t.device_mesh for t in tensors if isinstance(t, DTensor))


class _ContiguousGrad(torch.autograd.Function):
    """Identity on values; the gradient made contiguous.  A local
    backward may return a permuted gradient (attention's dV), and DTensor
    reshapes a gradient by viewing its local shard, which a permuted
    shard cannot be."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(fn):
    def local(*a):
        return fn(*(_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor) and t.requires_grad
                    else t for t in a))
    return local


def _local_map(fn, mesh, out_pl, in_pl, *args, in_grad=None):
    """``fn`` on each rank's local shards of ``args`` (plain tensors made
    replicated DTensors first), redistributed to ``in_pl``; the outputs
    laid out by ``out_pl``; the inputs' gradients by ``in_grad`` (default
    ``in_pl``: right for every input split like the batch, wrong for a
    weight replicated across it, whose local gradient is a partial sum),
    contiguous."""
    from torch.distributed.tensor.experimental import local_map

    args = tuple(_as_dtensor(a, mesh) for a in args)
    # one output's placements go as a list (a tuple is one entry an output)
    out_pl = list(out_pl) if not isinstance(out_pl[0], tuple) else out_pl
    return local_map(_contiguous_grads(fn), out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=in_grad, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def local_shards(layout):
    """Decorator for a function whose rows (and heads or channels) are
    independent: on plain tensors it runs as it is; where an argument is a
    DTensor it runs on each rank's local shards (``local_map``).
    ``layout(mesh, *args)`` returns ``(out_placements, in_placements,
    in_grad_placements, args)``: the placements of the outputs, of the
    leading tensor arguments (the rest, such as a window, pass through),
    of those arguments' gradients (None: as ``in_placements``), and the
    arguments to map, which the layout may reshape first.  Keyword
    arguments go to every local call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if not _is_dtensor(*args):
                return fn(*args, **kw)
            mesh = _mesh_of(*args)
            out_pl, in_pl, in_grad, args = layout(mesh, *args)
            rest = (None,) * (len(args) - len(in_pl))
            in_grad = None if in_grad is None else tuple(in_grad) + rest
            return _local_map(lambda *a: fn(*a, **kw), mesh, out_pl, tuple(in_pl) + rest,
                              *args, in_grad=in_grad)
        return wrapped
    return deco


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


def _attention_layout(mesh, q, k, v):
    """Heads over ``model`` only where both q's and k/v's divide it, so
    that every shard holds whole groups."""
    pl = _kernel_placements(mesh, q.shape[0], 2, (q.shape[2], k.shape[2]))
    return pl, (pl, pl, pl), None, (q, k, v)


@local_shards(_attention_layout)
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
    where = _device_type("flash_attention", q, k, v)
    if where == "meta":
        return torch.ops.repro_torch.flash_attention(q, k, v, causal)
    if where == "cpu":
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


def _train_attention_kernel(device_type: str, dtype: torch.dtype, d: int, group: int,
                            s: int, t: int) -> str:
    """Which path serves the training path's causal attention
    (``layers.attention.causal_attention``): ``"fused"``
    (``CausalAttention``: the training forward and the backward kernels)
    for bf16 on the card with head dim 64 or 128, a group ``H / K`` that
    divides 64 and as many keys as queries; ``"plain"`` (the masked
    ``sdpa`` under autograd) for everything else, the CPU and the meta
    device included."""
    if device_type == "cuda" and dtype == torch.bfloat16 and d in _TRAIN_HEAD_DIMS \
            and group >= 1 and _WGMMA_ROWS % group == 0 and s == t:
        return "fused"
    return "plain"


def train_attention_route(q, k, v) -> str:
    """``_train_attention_kernel`` for plain tensors q (B,S,H,D), k, v
    (B,T,K,D): what the call shows before any launch."""
    if len({q.device, k.device, v.device}) != 1 or len({q.dtype, k.dtype, v.dtype}) != 1 \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        return "plain"
    return _train_attention_kernel(q.device.type, q.dtype, q.shape[3], q.shape[2] // k.shape[2],
                                   q.shape[1], k.shape[1])


def _check_train(name: str, q, k, v) -> None:
    """What the training kernels take, checked before a launch."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    kh = k.shape[2]
    _check_cuda(name, (q, k, v), h, kh, d)
    if q.dtype != torch.bfloat16 or d not in _TRAIN_HEAD_DIMS or _WGMMA_ROWS % (h // kh):
        raise ValueError(f"{name}: takes bf16 with head dim {_TRAIN_HEAD_DIMS} and a group "
                         f"dividing {_WGMMA_ROWS}, got {q.dtype}, D {d}, group {h // kh}")
    if k.shape[1] == 0:
        raise ValueError(f"{name}: no keys")


def flash_attention_train(q, k, v):
    """The training path's causal attention forward: ``(o, lse)``, o
    (B,S,H,D) as ``flash_attention(q, k, v)`` gives it and lse (B,H,S) f32
    each row's log-sum-exp of its scaled scores, which the backward
    recomputes the weights from.  On the CPU ``ref.flash_attention_lse``;
    on the card the tensor-core kernel with its log-sum-exp epilogue
    (``fa_train_fwd_kernel``), or it raises."""
    if _on_cpu("flash_attention_train", q, k, v):
        return ref.flash_attention_lse(q, k, v)
    _check_train("flash_attention_train", q, k, v)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        _launch("flash_attention_train", "repro_torch_flash_attention_train_fwd", q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, t, h, kh, d,
                torch.cuda.current_stream().cuda_stream)
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do):
    """The causal attention's gradient ``(dq, dk, dv)`` in the inputs'
    dtype, from the forward's q, k, v, o and lse and the output gradient
    ``do``.  On the CPU ``ref.flash_attention_bwd``; on the card one launch
    of three kernels (``csrc/flash_attention_bwd.cu``: the rows' Δ, dQ a
    query tile, dK and dV a key tile), counted once, or it raises."""
    if _on_cpu("flash_attention_bwd", q, k, v, o, lse, do):
        return ref.flash_attention_bwd(q, k, v, o, lse, do)
    _check_train("flash_attention_bwd", q, k, v)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    _check_cuda("flash_attention_bwd", (o, do), h, kh, d)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} against q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous f32 {(b, h, s)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("flash_attention_bwd", "repro_torch_flash_attention_bwd", q.data_ptr(),
                k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, t, h, kh, d,
                torch.cuda.current_stream().cuda_stream)
    return dq, dk, dv


class CausalAttention(torch.autograd.Function):
    """Causal attention under autograd on the training kernels: the
    forward is ``flash_attention_train`` and saves q, k, v, o and lse; the
    backward is ``flash_attention_bwd``.  Nothing of S x T is kept or
    written, so under ``remat="dots"`` there is nothing left in it to
    recompute.  Inputs are made contiguous first (a no-op on the training
    path); gradients come back in the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_train(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do.contiguous())


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
    picks the kernel from dtype and D: head dim 256 only in bf16.  The
    kernels also give each row's log-sum-exp (``_decode``), by which a
    cache split over positions combines its slices."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"flash_decode: shapes {q.shape}, {k_cache.shape}, {v_cache.shape}"
        )
    b, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or cur_index.shape != (b,):
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"cur {tuple(cur_index.shape)}"
        )
    if _is_dtensor(q, k_cache, v_cache, cur_index):
        return _decode_dtensor(q, k_cache, v_cache, cur_index)
    return _decode(q, k_cache, v_cache, cur_index)[0]


def _decode_dtensor(q, k_cache, v_cache, cur_index):
    """``_decode`` on DTensors.  A cache whose positions are split over
    ``model`` (``cache_pspecs``'s layout) stays so: each rank runs the
    kernel on its slice of positions (the query and ``cur`` whole on
    ``model``), a slice wholly past ``cur`` weighs nothing, and the
    slices' outputs are combined by their log-sum-exps, sums of (B,H,D)
    and (B,H) over ``model``.  Any other cache runs on the kernel's own
    layout (heads over ``model`` where q's and the cache's divide it)."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = _mesh_of(q, k_cache, v_cache, cur_index)
    names = tuple(mesh.mesh_dim_names or ())
    b, h, kh = q.shape[0], q.shape[1], k_cache.shape[2]
    rows = _kernel_placements(mesh, b, None, ())
    m = names.index("model") if "model" in names else None
    if m is None or not isinstance(k_cache, DTensor) or k_cache.placements[m] != Shard(1):
        qp = _kernel_placements(mesh, b, 1, (h, kh))
        cp = _kernel_placements(mesh, b, 2, (h, kh))
        return _local_map(lambda *a: _decode(*a)[0], mesh, qp, (qp, cp, cp, rows),
                          q, k_cache, v_cache, cur_index)
    cp = tuple(Shard(1) if i == m else p for i, p in enumerate(rows))
    # one partial a slice, stacked on a new leading dim split over ``model``
    parts = tuple(Shard(0) if i == m else Shard(p.dim + 1) if p.is_shard() else p
                  for i, p in enumerate(rows))
    off = mesh.get_local_rank(m) * (k_cache.shape[1] // mesh.shape[m])

    def part(q, k, v, cur):
        out, lse = _decode(q, k, v, (cur - off).clamp(min=0).to(torch.int32))
        lse = torch.where(cur[:, None] < off, float("-inf"), lse)
        return out[None], lse[None]

    out, lse = _local_map(part, mesh, (parts, parts), (rows, cp, cp, rows),
                          q, k_cache, v_cache, cur_index)
    top = lse.amax(0)
    w = torch.exp(lse - top)
    den = w.sum(0)
    return ((out.float() * w[..., None]).sum(0) / den[..., None]).to(q.dtype)


def _decode(q, k_cache, v_cache, cur_index):
    """``flash_decode`` on plain tensors: ``(out, lse)``, lse (B,H) f32
    each row's log-sum-exp of its scaled scores over the positions it
    attends (``torch.ops.repro_torch.flash_decode`` on every device)."""
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    where = _device_type("flash_decode", q, k_cache, v_cache, cur_index)
    if where == "meta":
        return torch.ops.repro_torch.flash_decode(q, k_cache, v_cache, cur_index)
    if where == "cpu":
        return ref.flash_decode(q, k_cache, v_cache, cur_index, return_lse=True)
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
    lse = torch.empty(b, h, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cur_index.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, t, h, kh, d)
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
    return out, lse


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


def _scan_layout(outputs: int):
    """The scans' layout: the batch over the data dims, the width over
    ``model`` where it divides it, time whole."""
    def layout(mesh, *ts):
        pl = _kernel_placements(mesh, ts[0].shape[0], 2, (ts[0].shape[2],))
        return (pl if outputs == 1 else (pl,) * outputs), (pl,) * len(ts), None, ts
    return layout


@local_shards(_scan_layout(1))
def rglru_scan(a, x):
    """The RG-LRU recurrence ``h_t = a_t·h_{t-1} + x_t`` over axis 1 from
    ``h_{-1} = 0``: a, x (B,T,W), cast to f32; returns h (B,T,W) f32."""
    _check_scan_shapes("rglru_scan", a, x)
    where = _device_type("rglru_scan", a, x)
    if where == "meta":
        return torch.ops.repro_torch.rglru_scan(a, x)
    if where == "cpu":
        return ref.rglru_scan(a, x)
    a, x = a.float().contiguous(), x.float().contiguous()
    h = torch.empty_like(x)
    _scan_launch("rglru_scan", "repro_torch_rglru_scan", "repro_torch_rglru_scan_ring",
                 [a, x], [h])
    return h


@local_shards(_scan_layout(2))
def rglru_scan_bwd(a, h, dh):
    """The scan's gradient: from the forward's ``a`` and ``h`` and the
    output gradient ``dh`` (all (B,T,W)), returns ``(dx, da)`` in f32:
    ``g_t = dh_t + a_{t+1}·g_{t+1}`` from the last step, ``dx_t = g_t``,
    ``da_t = g_t·h_{t-1}``."""
    _check_scan_shapes("rglru_scan_bwd", a, h, dh)
    where = _device_type("rglru_scan_bwd", a, h, dh)
    if where == "meta":
        return torch.ops.repro_torch.rglru_scan_bwd(a, h, dh)
    if where == "cpu":
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


# ------------------------------------------------ custom ops (meta device)
# K4, K5 and K6 as ``torch.ops.repro_torch.*``: on the meta device their
# fake implementations run, and a dispatch trace (the dry run's recorder,
# ``launch.comm_stats``) sees one op with the FLOPs registered here and the
# bytes of its inputs and outputs.  On the CPU and the card the op calls
# the wrapper.


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor")
def _flash_attention_op(q, k, v, causal):
    return flash_attention(q, k, v, causal)


@_flash_attention_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, *args, out_shape=None, **kwargs) -> int:
    b, s, h, d = q_shape
    t = k_shape[1]
    m = min(s, t)  # causal: query i attends min(i + 1, t) keys
    pairs = m * (m + 1) // 2 + (s - m) * t if causal else s * t
    return 4 * b * h * d * pairs


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, Tensor cur) -> (Tensor, Tensor)")
def _flash_decode_op(q, k_cache, v_cache, cur_index):
    return _decode(q, k_cache, v_cache, cur_index)


@_flash_decode_op.register_fake
def _(q, k_cache, v_cache, cur_index):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _(q_shape, k_shape, v_shape, cur_shape, *args, out_shape=None, **kwargs) -> int:
    b, h, d = q_shape
    return 4 * b * h * d * k_shape[1]


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=(),
                         schema="(Tensor a, Tensor x) -> Tensor")
def _rglru_scan_op(a, x):
    return rglru_scan(a, x)


@_rglru_scan_op.register_fake
def _(a, x):
    return x.new_empty(x.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _(a_shape, x_shape, *args, out_shape=None, **kwargs) -> int:
    b, t, w = x_shape
    return 2 * b * t * w


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=(),
                         schema="(Tensor a, Tensor h, Tensor dh) -> (Tensor, Tensor)")
def _rglru_scan_bwd_op(a, h, dh):
    return rglru_scan_bwd(a, h, dh)


@_rglru_scan_bwd_op.register_fake
def _(a, h, dh):
    return dh.new_empty(dh.shape, dtype=torch.float32), dh.new_empty(dh.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.rglru_scan_bwd)
def _(a_shape, h_shape, dh_shape, *args, out_shape=None, **kwargs) -> int:
    b, t, w = dh_shape
    return 3 * b * t * w
