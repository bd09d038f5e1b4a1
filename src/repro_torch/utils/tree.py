"""Tree utilities over the port's parameter and state trees: nested dicts,
lists and tuples with tensors (or arrays) at the leaves, as the JAX
package's pytrees.  Leaves are visited in JAX's order (dict keys sorted,
sequences by index), so paths and leaf lists line up with
``jax.tree_util`` on the same tree."""
from __future__ import annotations

import math
from typing import Any, Callable, Iterable, List, Tuple

import numpy as np


def path_str(path) -> str:
    """Render a tree path (its dict keys and sequence indices) as a
    '/'-joined string, as ``repro.utils.tree.path_str`` renders JAX's."""
    return "/".join(str(p) for p in path)


def flatten_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's flattening order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in flatten_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_unflatten(template, leaves: Iterable):
    """A tree shaped as ``template`` holding ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def map_with_path(fn: Callable[[str, Any], Any], tree):
    """``tree_map`` where ``fn`` receives ``(path string, leaf)``: the
    strings of ``repro.utils.tree.map_with_path`` on the same tree
    (``stages/<i>/<pos>/attn/wq``)."""
    return _map_path(fn, tree, ())


def _map_path(fn, tree, prefix):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(path_str(prefix), tree)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_param_count(tree: Any) -> int:
    """The entries of every leaf (tensors or arrays), summed."""
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree) if x is not None))


def tree_bytes(tree: Any) -> int:
    """The bytes of every leaf: entries times the dtype's item size (a
    torch or numpy dtype, or anything ``np.dtype`` takes)."""
    total = 0
    for x in tree_leaves(tree):
        if x is None:
            continue
        dt = np.dtype(x.dtype) if not hasattr(x.dtype, "itemsize") else x.dtype
        total += math.prod(x.shape) * dt.itemsize
    return int(total)
