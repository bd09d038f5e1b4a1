"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks, 7:1 pattern.

48L d_model=2048 4H vocab=50304 d_ff=0 [arXiv:2405.04517].
d_ff=0 means no standard FFN: mLSTM blocks carry an internal 2× up
projection; sLSTM blocks get the xLSTM-paper 4/3 GeGLU FFN.
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        rope=False,
        stages=(
            (("mlstm",) * 7 + ("slstm",), 6),  # 48 layers, 7:1 m:s
        ),
        mlstm_proj_factor=2.0,
        mlstm_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-smoke",
        family="ssm",
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        rope=False,
        stages=(
            (("mlstm", "slstm"), 2),
        ),
        mlstm_proj_factor=2.0,
        mlstm_chunk=16,
    )
