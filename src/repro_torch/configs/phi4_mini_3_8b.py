"""phi4-mini-3.8b [dense]: RoPE SwiGLU GQA.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 [arXiv:2412.08905].
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200064,
        activation="swiglu",
        stages=((("attn",), 32),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b-smoke",
        family="dense",
        d_model=48,
        num_heads=6,
        num_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=512,
        activation="swiglu",
        stages=((("attn",), 2),),
    )
