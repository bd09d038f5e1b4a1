"""The yardstick's counts against values worked out by hand."""
from __future__ import annotations

import json

import pytest

from conftest import BENCH, MOE
from harness import flops

TINY = {"hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2,
        "intermediate_size": 3, "vocab_size": 5, "num_hidden_layers": 1}
TINY_MOE = dict(TINY, num_experts=3, num_experts_per_tok=2, moe_intermediate_size=3,
                shared_expert_intermediate_size=2)
del TINY_MOE["intermediate_size"]


def test_matrix_params_by_hand():
    # q and o: 4·2·2 each; k and v: 4·1·2 each; FFN 3·4·3; lm_head 4·5
    assert flops.matrix_params(TINY) == 16 + 16 + 8 + 8 + 36 + 20
    assert flops.matrix_params(TINY, lm_head=False) == 84
    # router 4·3; two routed experts 2·3·4·3; shared 3·4·2
    assert flops.matrix_params(TINY_MOE) == 48 + 12 + 72 + 24 + 20


def test_an_expert_share_by_hand():
    """A chip holding 3 of the 6 experts its router routes over: the
    router at 6, k = 2 routed experts a token of which this chip computes
    2 × 3 / 6 = 1 on average, the shared expert once."""
    share = dict(MOE, num_experts=3, published={"num_experts": 6})
    assert flops.experts(share) == (3, 6) and flops.experts(MOE) == (6, 6)
    # attention 64·4·16·2 + 64·4·16·2; router 64·6; one expert 3·64·64;
    # shared 3·64·128; 2 layers; lm_head 64·512
    per_layer = 8192 + 8192 + 384 + 12288 + 24576
    assert flops.matrix_params(share) == 2 * per_layer + 32768 == 140032
    # all six held: two whole experts a token
    assert flops.matrix_params(MOE) == 2 * (per_layer + 12288) + 32768


def test_train_flops_per_token_by_hand():
    # 6 · 104 + 6 · (1 layer · 2 heads · 2) · seq 8
    assert flops.train_flops_per_token(TINY, 8) == 6 * 104 + 6 * 4 * 8


def test_published_sizes():
    g = json.loads((BENCH / "configs" / "granite-3-8b-12l.json").read_text())
    # per layer 41,943,040 (attention) + 157,286,400 (FFN); 12 layers and lm_head 201,338,880
    assert flops.matrix_params(g) == 12 * 199_229_440 + 201_338_880 == 2_592_092_160
    assert flops.train_flops_per_token(g, 4096) == 16_760_512_512
    q = json.loads((BENCH / "configs" / "qwen2-moe-a2.7b-4l.json").read_text())
    # attention 16,777,216 + router 122,880 + 4 routed 34,603,008 + shared 34,603,008
    assert flops.matrix_params(q) == 4 * 86_106_112 + 311_164_928
    assert flops.train_flops_per_token(q, 4096) == 4_134_862_848


def test_serving_flops_by_hand():
    # a prompt of 3: 2 · 84 · 3 + lm_head once 2 · 4 · 5 + 4 · 4 · (1 + 2 + 3)
    assert flops.prefill_flops(TINY, 3) == 504 + 40 + 96
    # two rows attending 5 and 7 positions: 2 · 104 each + 4 · 4 · 12
    assert flops.decode_flops(TINY, [5, 7]) == 2 * 2 * 104 + 4 * 4 * 12


def test_kernel_bounds_by_hand():
    # K4, one prompt of 3: 4 · 2 · 2 · 6 = 96 FLOPs; q, o 3·2·2 and k, v 3·1·2
    # elements of 2 bytes: 2 · (24 + 12) = 72 bytes
    assert flops.k4_bound_s(TINY, [3]) == pytest.approx(max(96 / 989e12, 72 / 3.35e12))
    # K6, rows attending 5 and 7: 4 · 2 · 2 · 12 FLOPs; K and V over 12
    # positions of one head of 2, q and o of two rows: 2 · (48 + 16) bytes
    assert flops.k6_bound_s(TINY, [[5, 7]]) == pytest.approx(
        max(192 / 989e12, 128 / 3.35e12))
    assert flops.k6_bound_s(TINY, [[]]) == 0.0
