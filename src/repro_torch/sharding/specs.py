"""Partition-spec rules: map parameter/batch/cache trees to specs, the
port of ``repro.sharding.specs`` rule for rule, and the DTensor layout
they give.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated),
a mesh dim's name, or a tuple of names (the dim split over those mesh
dims, major to minor), which is what JAX's ``PartitionSpec`` holds.
``mesh`` is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``, or a ``SimpleNamespace`` in the tests).

Strategies
----------
``tp``       Megatron tensor parallelism over the ``model`` axis only;
             params replicated over data axes (small models).
``fsdp_tp``  TP over ``model`` + FSDP/ZeRO-style sharding of the remaining
             large parameter dim (and optimizer state) over ``data``
             (large models; DTensor gathers each layer's weights where a
             product needs them).

Multi-pod meshes add a leading ``pod`` axis used purely for data
parallelism: batch shards over ("pod","data"), parameters stay replicated
across pods, so gradient sync over the slow DCN axis is one all-reduce.

Recurrent-block params (rglru / mlstm / slstm) do not TP-shard: their head
counts (10, 4) don't divide the 16-wide model axis; they still FSDP over
``data``.

``placements(spec, mesh)`` turns a spec into DTensor placements and
``distribute_tree(tree, specs, mesh)`` lays a tree out by its specs.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Sequence, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.utils.tree import map_with_path, tree_leaves, tree_unflatten

MODEL = "model"
DATA = "data"


def _axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))[name]


def _div(n: int, d: int) -> bool:
    return n % d == 0 and n >= d


def param_pspecs(cfg: ModelConfig, shapes, mesh, strategy: str = "fsdp_tp"):
    """shapes: the parameter tree (tensors on any device; only shapes are
    read)."""
    msz = _axis_size(mesh, MODEL)
    dsz = _axis_size(mesh, DATA)
    fsdp = strategy == "fsdp_tp"

    def fsdp_dim(shape, taken: Sequence[int]) -> Optional[int]:
        """largest dim not already sharded, divisible by data axis."""
        if not fsdp:
            return None
        cand = [
            (size, i)
            for i, size in enumerate(shape)
            if i not in taken and _div(size, dsz)
        ]
        if not cand:
            return None
        return max(cand)[1]

    def spec_for(path: str, x) -> tuple:
        shape = tuple(x.shape)
        ndim = len(shape)
        lead = 1 if re.search(r"stages/\d+/\d+/", path) else 0  # layer-stack dim
        axes: list = [None] * ndim

        def tp(i: int):
            """try to TP-shard absolute index (after lead offset)."""
            if 0 <= i < ndim and _div(shape[i], msz):
                axes[i] = MODEL
                return True
            return False

        name = path.split("/")[-1]
        parent = path.split("/")[-2] if "/" in path else ""

        if path == "embed" or name == "embed":
            if cfg.shard_vocab_embed:
                tp(0)  # vocab parallelism
            elif _div(shape[-1], dsz):
                axes[-1] = DATA  # d over data; token gather stays local
        elif name == "lm_head":
            tp(1)  # vocab
        elif parent == "attn" or parent == "cross":
            if name == "wq":
                tp(lead + 1)  # heads
            elif name in ("wk", "wv"):
                tp(lead + 1)  # kv heads if divisible, else replicated
            elif name == "wo":
                tp(lead + 0)  # heads (contraction -> partial sums)
        elif parent in ("ffn", "shared"):
            if name in ("w_in", "w_gate"):
                tp(lead + 1)
            elif name == "w_out":
                tp(lead + 0)
        elif parent == "moe":
            if name in ("w_in", "w_gate"):
                tp(lead + 0) or tp(lead + 2)  # experts, else expert-ff
            elif name == "w_out":
                tp(lead + 0) or tp(lead + 1)
            # router stays replicated over model
        # recurrent blocks (rglru/mlstm/slstm): no TP (head counts don't
        # divide the model axis) — FSDP only.

        taken = [i for i, a in enumerate(axes) if a is not None]
        if lead:
            taken.append(0)  # never shard the layer-stack dim
        big = math.prod(shape) if shape else 0
        if big >= 1 << 16 and DATA not in axes:  # don't double-use the axis
            fd = fsdp_dim(shape, taken)
            if fd is not None:
                axes[fd] = DATA
        return tuple(axes)

    return map_with_path(spec_for, shapes)


def state_pspecs(cfg: ModelConfig, state_shapes, mesh, strategy: str = "fsdp_tp"):
    """Shardings for the full train state {params, opt{mu,nu,master?,count}, step}.

    Optimizer moments follow their parameter's spec (ZeRO-1-ish when
    strategy shards params over data).
    """
    pspec = param_pspecs(cfg, state_shapes["params"], mesh, strategy)
    out = {"params": pspec, "opt": {}, "step": ()}
    for key in state_shapes["opt"]:
        if key == "count":
            out["opt"][key] = ()
        else:
            out["opt"][key] = pspec
    return out


def batch_pspecs(batch_shapes, mesh, dp_axes: Tuple[str, ...]):
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    dp_size = math.prod(_axis_size(mesh, a) for a in dp_axes)

    def spec_for(path: str, x):
        if x.dim() == 0:
            return ()
        if _div(x.shape[0], dp_size):
            return (dp,) + (None,) * (x.dim() - 1)
        return (None,) * x.dim()

    return map_with_path(spec_for, batch_shapes)


def cache_pspecs(cache_shapes, mesh, dp_axes: Tuple[str, ...]):
    """Decode-cache rule: batch dim over DP axes when divisible; then the
    first later axis divisible by the model axis shards over ``model``
    (seq-sharded KV — flash-decode combines are small sums)."""
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    dp_size = math.prod(_axis_size(mesh, a) for a in dp_axes)
    msz = _axis_size(mesh, MODEL)

    def spec_for(path: str, x):
        if x.dim() == 0:
            return ()
        axes: list = [None] * x.dim()
        start = 0
        # caches of stacked stages carry a leading layer-stack dim; detect
        # by path ("stages/...") and skip it
        if path.startswith("stages/"):
            start = 1
        if x.dim() > start and _div(x.shape[start], dp_size):
            axes[start] = dp
        for i in range(start + 1, x.dim()):
            if _div(x.shape[i], msz):
                axes[i] = MODEL
                break
        return tuple(axes)

    return map_with_path(spec_for, cache_shapes)


# ------------------------------------------------------------- DTensor


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements, one per mesh dim, of a spec: ``Shard(i)`` on
    every mesh dim that tensor dim ``i`` names (a tuple of names gives a
    ``Shard(i)`` on each, major to minor, which must be the mesh's own
    order), ``Replicate()`` on the rest and on a mesh dim of size 1 (the
    same layout, and DTensor's views cannot merge a dim of size 1 that
    is marked split)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        for m in dims:
            if out[m] != Replicate():
                raise ValueError(f"spec {spec}: mesh dim {names[m]!r} shards two tensor dims")
            out[m] = Shard(i)
    sizes = tuple(mesh.shape)
    return tuple(Replicate() if sizes[m] == 1 else p for m, p in enumerate(out))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, (str, tuple)) for a in x)


def distribute_tree(tree, specs, mesh):
    """``tree`` with every tensor leaf a DTensor on ``mesh``, laid out by
    its spec in ``specs`` (a tree of the same structure with spec
    tuples at the leaves).  Every rank passes the same whole tree, as
    ``distribute_tensor`` takes it; a leaf that no placement splits
    (every mesh dim it names of size 1) is wrapped as it is, without a
    copy or a collective.  A leaf that is a DTensor already is
    redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    leaves = tree_leaves(tree)
    spec_leaves = _spec_leaves(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    out = []
    for x, spec in zip(leaves, spec_leaves):
        pl = placements(spec, mesh)
        if isinstance(x, DTensor):
            out.append(x.redistribute(mesh, pl))
        elif all(p.is_replicate() or mesh.shape[m] == 1 for m, p in enumerate(pl)):
            out.append(DTensor.from_local(x, mesh, pl, run_check=False))
        else:
            out.append(distribute_tensor(x, mesh, pl))
    return tree_unflatten(tree, out)


def _spec_leaves(specs) -> list:
    """The spec tuples of a spec tree in flattening order (a spec is a
    tuple, so it must not be walked into as a sequence)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if _is_spec(specs):
        return [specs]
    return [s for v in specs for s in _spec_leaves(v)]
