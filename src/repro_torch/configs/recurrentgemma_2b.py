"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, pattern (R,R,A).

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427].
26 = 8×(R,R,A) + (R,R).
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        activation="geglu",
        stages=(
            (("rglru", "rglru", "local_attn"), 8),
            (("rglru", "rglru"), 1),
        ),
        local_window=2048,
        rnn_width=2560,
        conv_width=4,
        tie_embeddings=True,  # Gemma family ties embed/lm_head
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        family="hybrid",
        d_model=64,
        num_heads=2,
        num_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        activation="geglu",
        stages=(
            (("rglru", "rglru", "local_attn"), 2),
            (("rglru", "rglru"), 1),
        ),
        local_window=16,
        rnn_width=64,
        conv_width=4,
    )
