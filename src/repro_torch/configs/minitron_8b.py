"""minitron-8b [dense]: pruned Nemotron.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000 [arXiv:2407.14679].
Nemotron uses a non-gated squared-ReLU-style MLP; we use non-gated GeLU so
the 2×d×ff parameter layout matches the published d_ff.
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=256000,
        activation="gelu",
        stages=((("attn",), 32),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-smoke",
        family="dense",
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        activation="gelu",
        stages=((("attn",), 2),),
    )
