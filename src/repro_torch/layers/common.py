"""Shared primitives: init, norms, activations, the sharding hints
(``ShardCtx``), the remat segment and the weight cast that
``remat="dots"`` recasts in the backward."""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(
    shape: Sequence[int],
    dtype: torch.dtype,
    generator: torch.Generator,
    device,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-ish): a standard normal cut to
    [-2, 2], times ``1/sqrt(shape[0])`` unless ``scale`` is given."""
    shape = tuple(shape)
    if scale is None:
        fan_in = shape[0] if len(shape) >= 2 else max(1, shape[-1])
        scale = 1.0 / math.sqrt(fan_in)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def activation_fn(name: str):
    if name in ("gelu", "geglu"):
        return _gelu
    if name in ("swiglu", "silu"):
        return F.silu
    raise ValueError(name)


_LOCAL = threading.local()  # .casts: recast_weights's registry or None; .spmd


class ShardCtx:
    """Carries the mesh and the logical axis mapping for activation
    layouts, as the JAX package's ``ShardCtx``.

    ``hint(x, *spec)`` lays a DTensor out by ``spec`` (``"DP"`` the data
    dims, ``"TP"`` the model dim, else a mesh dim's name or ``None``):
    the redistribution ``with_sharding_constraint`` asks XLA for, except
    that a dim its mesh dims do not divide stays whole (XLA pads it;
    DTensor's uneven shards have no rule for the products' flattening).
    Without a mesh, or on a plain tensor, it returns ``x``, so the model
    code is mesh-agnostic."""

    def __init__(self, mesh=None, dp: Sequence[str] = ("data",), tp: str = "model"):
        self.mesh = mesh
        self.dp = tuple(dp)
        self.tp = tp

    def resolve(self, *spec) -> tuple:
        out = []
        for s in spec:
            if s == "DP":
                out.append(self.dp if len(self.dp) > 1 else self.dp[0])
            elif s == "TP":
                out.append(self.tp)
            else:
                out.append(s)
        return tuple(out)

    def hint(self, x: torch.Tensor, *spec) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        if self.mesh is None or not isinstance(x, DTensor):
            return x
        from repro_torch.sharding.specs import placements

        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        spec = list(self.resolve(*spec))
        for i, axes in enumerate(spec):  # a dim its mesh dims do not divide stays whole
            n = math.prod(sizes[a] for a in (axes if isinstance(axes, tuple) else (axes,))
                          if a is not None)
            if x.shape[i] % n:
                spec[i] = None
        return x.redistribute(self.mesh, placements(tuple(spec), self.mesh))


NULL_CTX = ShardCtx(mesh=None)


def _fit(x: torch.Tensor, need: dict, partial: bool) -> torch.Tensor:
    """A DTensor redistributed so that every tensor dim ``d`` in ``need``
    is split only by mesh dims whose sizes divide ``need[d]`` (``None``:
    not split at all); with ``partial``, partial sums are reduced too."""
    from torch.distributed.tensor import Replicate

    if not need and not partial:
        return x
    sizes = {}
    for m, p in enumerate(x.placements):
        d = getattr(p, "dim", None)
        if d is not None:
            sizes[d] = sizes.get(d, 1) * x.device_mesh.shape[m]
    bad = {d for d, n in need.items() if d in sizes and (n is None or n % sizes[d])}
    new = tuple(Replicate() if getattr(p, "dim", None) in bad or (partial and p.is_partial())
                else p for p in x.placements)
    return x if new == tuple(x.placements) else x.redistribute(x.device_mesh, new)


class _Fit(torch.autograd.Function):
    """Identity on values: the DTensor laid out by ``_fit(x, fwd)``, its
    gradient by ``_fit(g, bwd)``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, partial):
        ctx.bwd, ctx.partial = bwd, partial
        out = _fit(x, fwd, partial)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return _fit(g, ctx.bwd, ctx.partial), None, None, None


def _is_dt(x) -> bool:
    return getattr(x, "placements", None) is not None


def replicate_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with the tensor dims ``dims`` whole on every rank: a DTensor
    split on one of them, or holding partial sums, is redistributed to
    replicated on those mesh dims, and so is its gradient in the
    backward (DTensor would reduce partial sums onto any split).  For an
    op with no sharding rule for the split (an einsum's flattening of a
    dim its mesh dim does not divide): DTensor's propagation may give a
    product's output, or a gradient, any split.  A plain tensor is
    returned as it is."""
    if not _is_dt(x):
        return x
    need = {d % x.dim(): None for d in dims}
    return _Fit.apply(x, need, need, True)


def whole_op(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an op that has no DTensor sharding rule in every
    PyTorch the port runs on (``torch.roll`` in 2.11): a DTensor is made
    whole (replicated), ``fn`` runs on the local tensor, and the result
    is a replicated DTensor.  A plain tensor gets ``fn(x)``."""
    if not _is_dt(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * x.device_mesh.ndim
    local = x.redistribute(x.device_mesh, rep).to_local()
    return DTensor.from_local(fn(local), x.device_mesh, rep, run_check=False)


def unflatten(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``, for a DTensor too: ``dim`` keeps its
    split where the mesh dims divide the first factor, else it is made
    whole first; in the backward, the gradient's new dims are laid out
    so that flattening them back has a sharding rule."""
    if not _is_dt(x):
        return x.unflatten(dim, sizes)
    dim = dim % x.dim()
    x = _Fit.apply(x, {dim: sizes[0]}, {}, False)
    y = x.unflatten(dim, sizes)
    bwd = {d: None for d in range(dim + 1, dim + len(sizes))}
    bwd[dim] = sizes[0]
    return _Fit.apply(y, {}, bwd, False)


def flatten(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x.flatten(start, end)``, for a DTensor too: only the first merged
    dim may stay split (by mesh dims that divide it); in the backward,
    the gradient's merged dim is laid out so that it unflattens."""
    if not _is_dt(x):
        return x.flatten(start, end)
    start, end = start % x.dim(), end % x.dim()
    need = {d: None for d in range(start + 1, end + 1)}
    need[start] = x.shape[start]
    y = _Fit.apply(x, need, {}, False).flatten(start, end)
    return _Fit.apply(y, {}, {start: x.shape[start]}, False)


@contextlib.contextmanager
def spmd_scope(ctx: Optional[ShardCtx]):
    """With a mesh, run under DTensor's ``implicit_replication``: the plain
    constants the model makes (masks, default positions, zeros) meet the
    laid-out DTensors as replicated ones.  Re-entrant (the outermost scope
    holds it), since DTensor's own scope cannot nest.  Without a mesh, a
    no-op."""
    if ctx is None or ctx.mesh is None or getattr(_LOCAL, "spmd", False):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _LOCAL.spmd = True
    try:
        with implicit_replication():
            yield
    finally:
        _LOCAL.spmd = False


def segment(ckpt: bool, fn, *xs):
    """``fn(*xs)``: a stretch of a block's work between two matrix
    products.  With ``ckpt`` (``remat="dots"`` in training) it runs under
    ``checkpoint``: the backward recomputes it from its inputs, which are
    the products' outputs, and the products outside every segment keep
    their own inputs, so no product is recomputed (JAX's
    ``checkpoint_dots``).  The forward draws no random numbers."""
    if ckpt:
        return checkpoint(fn, *xs, use_reentrant=False, preserve_rng_state=False)
    return fn(*xs)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; a plain tensor itself."""
    return getattr(t, "_local_tensor", t)


def _storage_key(t: torch.Tensor):
    """The address of the bytes behind ``t`` (a DTensor's local shard's),
    or None where there are none (the meta device)."""
    local = _local(t)
    if local.device.type == "meta":
        return None
    return local.untyped_storage().data_ptr()


def cast(w: torch.Tensor, dtype) -> torch.Tensor:
    """``w.to(dtype)``: a weight cast at its use.  Inside
    ``recast_weights`` the cast is registered (by its local shard's
    storage for a DTensor; not at all on the meta device, which holds no
    bytes), so that autograd saves the weight it came from in its
    place."""
    c = w.to(dtype)
    casts = getattr(_LOCAL, "casts", None)
    if casts is not None and c is not w and _local(c).numel():
        key = _storage_key(c)
        if key is not None:
            casts[key] = (c, _Recast(w, dtype))
    return c


class _Recast:
    """One weight cast as the backward gets it back: cast again from the
    weight.  The recast is kept while saved views of it are still to be
    unpacked (a ragged product saves a view per expert)."""

    def __init__(self, w: torch.Tensor, dtype):
        self.w, self.dtype, self.pending, self.cast = w, dtype, 0, None

    def unpack(self) -> torch.Tensor:
        c = self.cast if self.cast is not None else self.w.detach().to(self.dtype)
        self.pending -= 1
        self.cast = c if self.pending > 0 else None
        return c


@contextlib.contextmanager
def recast_weights():
    """Autograd saves no weight cast made by ``cast`` in this scope (a
    pattern period under ``remat="dots"``): a saved tensor that lies in a
    registered cast's storage (the cast or a view of it) is saved as its
    weight, dtype, size, stride and offset, and the backward casts the
    weight again, as JAX's ``checkpoint_dots`` recomputes the casts.
    Recasting gives the same bits, so values do not change.  A DTensor is
    matched by its local shard, which is recast and viewed again, then
    wrapped back with the saved tensor's mesh, placements and global
    shape; on the meta device nothing is registered."""
    casts = {}

    def pack(t):
        key = _storage_key(t)
        hit = casts.get(key) if key is not None else None
        if hit is None:
            return t
        hit[1].pending += 1
        local = _local(t)
        layout = (t.device_mesh, t.placements, t.size(), t.stride()) if local is not t else None
        return hit[1], local.size(), local.stride(), local.storage_offset(), layout

    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        recast, size, stride, offset, layout = packed
        view = _local(recast.unpack()).as_strided(size, stride, offset)
        if layout is None:
            return view
        from torch.distributed.tensor import DTensor

        mesh, pl, gsize, gstride = layout
        return DTensor.from_local(view, mesh, pl, run_check=False, shape=gsize, stride=gstride)

    outer, _LOCAL.casts = getattr(_LOCAL, "casts", None), casts
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _LOCAL.casts = outer
        # every tensor saved in the scope keeps ``pack`` (and so this
        # registry) until the backward: drop the casts now
        casts.clear()
