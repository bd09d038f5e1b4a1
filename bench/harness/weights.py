"""Weights made from ``--seed``: the benchmark's own leaves, by name.

A configuration's reference module (``spec.reference``) lists its leaves
(``leaves(cfg)``: name, shape, scale) and where the program holds each
(``port_path(name)``).  Each leaf is drawn on its device by one call from
its own ``torch.Generator``, seeded from the run's seed and the leaf's
name, so a leaf comes out the same whichever order the leaves are made in
and whoever asks for it: the program's tree (``fill_port``) and the
reference's flat dict (``make``).  Layers are stacked on a leading axis,
one call a leaf.  Every leaf is a standard normal cut to [-2, 2], times
its scale.
"""
from __future__ import annotations

import hashlib
from typing import Dict

import torch


def leaf_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


@torch.no_grad()
def fill(t: torch.Tensor, seed: int, name: str, scale: float) -> torch.Tensor:
    """Draw leaf ``name`` into ``t`` (float32) in place."""
    gen = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, name))
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


def make(ref, cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The reference's weights: a flat dict of float32 leaves of the
    reference module ``ref``."""
    return {name: fill(torch.empty(shape, dtype=torch.float32, device=device), seed, name, scale)
            for name, shape, scale in ref.leaves(cfg)}


def make_one(ref, cfg: Dict, seed: int, name: str, device) -> torch.Tensor:
    (shape, scale), = [(s, c) for n, s, c in ref.leaves(cfg) if n == name]
    return fill(torch.empty(shape, dtype=torch.float32, device=device), seed, name, scale)


# ------------------------------------------------------- the port's tree

def port_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(port_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def by_name(ref, cfg: Dict, tree) -> Dict[str, torch.Tensor]:
    """The program's tree's leaves under the benchmark's leaf names."""
    names = {ref.port_path(n): n for n, _, _ in ref.leaves(cfg)}
    return {names[p]: t for p, t in port_leaves(tree).items()}


def fill_port(ref, cfg: Dict, seed: int, tree) -> None:
    """Draw every leaf into the program's parameter tree in place; the
    tree must hold exactly the configuration's leaves, float32, of the
    benchmark's shapes."""
    have = port_leaves(tree)
    want = {ref.port_path(n): (n, s, c) for n, s, c in ref.leaves(cfg)}
    if set(have) != set(want):
        raise ValueError(f"the program's parameter tree differs from the configuration's: "
                         f"only there {sorted(set(have) - set(want))}, "
                         f"only here {sorted(set(want) - set(have))}")
    for path, (name, shape, scale) in want.items():
        t = have[path]
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{path}: the program holds {tuple(t.shape)} {t.dtype}, "
                             f"the configuration says {shape} float32")
        fill(t, seed, name, scale)
