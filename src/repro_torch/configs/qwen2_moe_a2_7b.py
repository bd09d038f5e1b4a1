"""qwen2-moe-a2.7b [moe]: 60 routed top-4 + 4 shared experts.

24L d_model=2048 16H (kv=16, MHA) d_ff_expert=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B].  Shared expert hidden = 5632 (= 4×1408).
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151936,
        activation="swiglu",
        stages=((("moe",), 24),),
        moe=MoEConfig(
            num_experts=60,
            experts_per_token=4,
            d_ff_expert=1408,
            num_shared_experts=4,
            d_ff_shared=5632,
            capacity_factor=1.25,
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke",
        family="moe",
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab_size=512,
        activation="swiglu",
        stages=((("moe",), 2),),
        moe=MoEConfig(
            num_experts=6,
            experts_per_token=2,
            d_ff_expert=64,
            num_shared_experts=1,
            d_ff_shared=128,
            capacity_factor=1.25,
        ),
    )
