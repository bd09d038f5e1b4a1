"""dbrx-132b [moe]: 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352
[hf:databricks/dbrx-base].
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        activation="swiglu",
        stages=((("moe",), 40),),
        moe=MoEConfig(
            num_experts=16,
            experts_per_token=4,
            d_ff_expert=10752,
            capacity_factor=1.25,
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke",
        family="moe",
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation="swiglu",
        stages=((("moe",), 2),),
        moe=MoEConfig(
            num_experts=4,
            experts_per_token=2,
            d_ff_expert=128,
            capacity_factor=1.25,
        ),
    )
