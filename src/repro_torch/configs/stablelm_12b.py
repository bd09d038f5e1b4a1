"""stablelm-12b [dense].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352
[hf:stabilityai/stablelm-2-12b family].
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100352,
        activation="swiglu",
        stages=((("attn",), 40),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-smoke",
        family="dense",
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        activation="swiglu",
        stages=((("attn",), 2),),
    )
