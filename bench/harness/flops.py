"""The yardstick's arithmetic: the chip's peaks, a model's FLOPs, and the
operations and bytes the attention kernels need, all from a
configuration file's sizes and the shapes the traffic asked for.

Counts are of the work the requests need, never of what the program
happens to do: a prefill counts at its prompt's own length, not at the
padded capacity; a decode step counts its active rows over the positions
written so far; recomputed work is not counted.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

# One H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def experts(cfg: Dict) -> Tuple[int, int]:
    """``(held, routed)``: the experts a layer holds on this chip (the
    file's ``num_experts``, listed in ``reduced`` where it is a chip's
    share) and the router's width, the published count beside it
    (``published.num_experts``) where the file gives one."""
    held = cfg["num_experts"]
    return held, cfg.get("published", {}).get("num_experts", held)


def matrix_params(cfg: Dict, lm_head: bool = True) -> float:
    """Matrix parameters one token uses: attention's four projections, the
    FFN of every layer, and the output head (``lm_head``, or the
    embedding's transpose where they are tied).  A MoE layer's FFN is the
    router at its routed width, k routed experts a token of which a chip
    holding ``held`` of ``routed`` computes k × held / routed on average,
    and the shared experts once.  The embedding gather is not a
    product."""
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    per_layer = d * h * hd * 2 + d * kv * hd * 2
    if "num_experts" in cfg:
        held, routed = experts(cfg)
        per_layer += d * routed
        per_layer += cfg["num_experts_per_tok"] * held * 3 * d * cfg["moe_intermediate_size"] / routed
        per_layer += 3 * d * cfg.get("shared_expert_intermediate_size", 0)
    else:
        per_layer += 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * per_layer + (d * cfg["vocab_size"] if lm_head else 0)


def attn_width(cfg: Dict) -> int:
    """layers × heads × head_dim."""
    return cfg["num_hidden_layers"] * cfg["num_attention_heads"] * cfg["head_dim"]


def train_flops_per_token(cfg: Dict, seq: int) -> float:
    """6 × the matrix parameters a token uses, plus 6 × layers × heads ×
    head_dim × seq for causal attention (forward and backward)."""
    return 6.0 * matrix_params(cfg) + 6.0 * attn_width(cfg) * seq


def prefill_flops(cfg: Dict, length: int) -> float:
    """Forward FLOPs of one prompt of ``length``: 2 × the matrix
    parameters for every token (``lm_head`` at the last one only), plus 4
    × layers × heads × head_dim × the positions each token attends."""
    mats = 2.0 * matrix_params(cfg, lm_head=False) * length
    head = 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
    return mats + head + 4.0 * attn_width(cfg) * length * (length + 1) / 2


def decode_flops(cfg: Dict, attended: Iterable[int]) -> float:
    """Forward FLOPs of one decode step whose active rows attend
    ``attended`` positions each (their cache positions written so far)."""
    attended = list(attended)
    per_token = 2.0 * matrix_params(cfg)
    return per_token * len(attended) + 4.0 * attn_width(cfg) * sum(attended)


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def k4_bound_s(cfg: Dict, lengths: Sequence[int]) -> float:
    """Least time of the prefill attention kernel over every layer of the
    prompts ``lengths``: causal QKᵀ and PV at each prompt's own length, q,
    k, v read and o written once, bf16."""
    h, kv, hd, n = (cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"],
                    cfg["num_hidden_layers"])
    total = 0.0
    for s in lengths:
        flops = 4.0 * h * hd * s * (s + 1) / 2
        nbytes = BF16 * (2 * s * h * hd + 2 * s * kv * hd)
        total += n * _bound(flops, nbytes)
    return total


def k6_bound_s(cfg: Dict, steps: Sequence[Sequence[int]]) -> float:
    """Least time of the decode attention kernel over every layer of the
    decode steps ``steps``, each the positions its active rows attend: K
    and V read over those positions, q read and o written once, bf16."""
    h, kv, hd, n = (cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"],
                    cfg["num_hidden_layers"])
    total = 0.0
    for rows in steps:
        if not rows:
            continue
        t = sum(rows)
        flops = 4.0 * h * hd * t
        nbytes = BF16 * (2 * t * kv * hd + 2 * len(rows) * h * hd)
        total += n * _bound(flops, nbytes)
    return total
