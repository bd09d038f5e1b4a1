"""Carry the JAX package's parameters into the port.

JAX's PRNG and torch's differ, so the same seed gives different weights;
sharing the weights themselves is how the tests hold the two packages to
the same outputs.  The port's parameter tree has the JAX layout leaf for
leaf (stages stacked ``(L, ...)``), so the import is a conversion of
every leaf.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    # a copy either way: the source may be read-only (a JAX array's
    # buffer) and the port updates its parameters in place
    if a.dtype.name == "bfloat16":  # ml_dtypes: numpy has no bf16 of its own
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def params_from_jax(tree, device="cpu"):
    """The port's parameters from a JAX ``init_params`` tree whose leaves
    are numpy (or numpy-convertible) arrays."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _leaf(tree, device)
