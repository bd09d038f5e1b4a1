"""Weights made from ``--seed``: the benchmark's own leaves, by name.

Each leaf is drawn on its device by one call from its own
``torch.Generator``, seeded from the run's seed and the leaf's name, so a
leaf comes out the same whichever order the leaves are made in and
whoever asks for it: the program's tree (``fill_port``) and the
reference's flat dict (``make``).  Layers are stacked on a leading axis,
one call a leaf.  Matrices are a standard normal cut to [-2, 2], times
1/sqrt(fan-in); the embedding's rows are at 0.02; the norm scales (read
as ``1 + scale``) at 0.1.  A configuration with tied embeddings has no
``lm_head``: its logits are the embedding's transpose.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], float]


def leaves(cfg: Dict) -> List[Leaf]:
    """``(name, shape, scale)`` of every leaf of a configuration file's
    model, in the benchmark's naming."""
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    n, v = cfg["num_hidden_layers"], cfg["vocab_size"]
    out: List[Leaf] = [("embed", (v, d), 0.02), ("final_norm", (d,), 0.1)]
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", (d, v), d ** -0.5))
    out += [
        ("layers/norm1", (n, d), 0.1),
        ("layers/norm2", (n, d), 0.1),
        ("layers/attn/wq", (n, d, h, hd), d ** -0.5),
        ("layers/attn/wk", (n, d, kv, hd), d ** -0.5),
        ("layers/attn/wv", (n, d, kv, hd), d ** -0.5),
        ("layers/attn/wo", (n, h, hd, d), (h * hd) ** -0.5),
    ]
    if "num_experts" not in cfg:
        f = cfg["intermediate_size"]
        return out + [("layers/ffn/w_in", (n, d, f), d ** -0.5),
                      ("layers/ffn/w_gate", (n, d, f), d ** -0.5),
                      ("layers/ffn/w_out", (n, f, d), f ** -0.5)]
    e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    out += [("layers/moe/router", (n, d, e), d ** -0.5),
            ("layers/moe/w_in", (n, e, d, f), d ** -0.5),
            ("layers/moe/w_gate", (n, e, d, f), d ** -0.5),
            ("layers/moe/w_out", (n, e, f, d), f ** -0.5)]
    if "shared_expert_intermediate_size" in cfg:
        fs = cfg["shared_expert_intermediate_size"]
        out += [("layers/shared/w_in", (n, d, fs), d ** -0.5),
                ("layers/shared/w_gate", (n, d, fs), d ** -0.5),
                ("layers/shared/w_out", (n, fs, d), fs ** -0.5)]
    return out


def leaf_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


@torch.no_grad()
def fill(t: torch.Tensor, seed: int, name: str, scale: float) -> torch.Tensor:
    """Draw leaf ``name`` into ``t`` (float32) in place."""
    gen = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, name))
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The reference's weights: a flat dict of float32 leaves."""
    return {name: fill(torch.empty(shape, dtype=torch.float32, device=device), seed, name, scale)
            for name, shape, scale in leaves(cfg)}


def make_one(cfg: Dict, seed: int, name: str, device) -> torch.Tensor:
    (shape, scale), = [(s, c) for n, s, c in leaves(cfg) if n == name]
    return fill(torch.empty(shape, dtype=torch.float32, device=device), seed, name, scale)


# ------------------------------------------------------- the port's tree

_PORT_NAMES = {"layers/moe/router": "moe/router", "layers/moe/w_in": "moe/w_in",
               "layers/moe/w_gate": "moe/w_gate", "layers/moe/w_out": "moe/w_out",
               "layers/shared/w_in": "moe/shared/w_in", "layers/shared/w_gate": "moe/shared/w_gate",
               "layers/shared/w_out": "moe/shared/w_out"}


def port_path(name: str) -> str:
    """The path of a leaf in the program's parameter tree (one stage of
    one block kind): ``layers/...`` lives at ``stages/0/0/...``."""
    if not name.startswith("layers/"):
        return name
    return "stages/0/0/" + _PORT_NAMES.get(name, name[len("layers/"):])


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


def fill_port(cfg: Dict, seed: int, tree) -> None:
    """Draw every leaf into the program's parameter tree in place; the
    tree must hold exactly the configuration's leaves, float32, of the
    benchmark's shapes."""
    have = port_leaves(tree)
    want = {port_path(n): (n, s, c) for n, s, c in leaves(cfg)}
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
