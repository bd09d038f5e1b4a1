"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution (frontend STUB).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2409.12191].
The vision frontend is a stub: the batch's ``positions_3d`` extra
provides 3-axis position ids (temporal, height, width) consumed by
M-RoPE; patch embeddings would occupy token positions.  M-RoPE
sections (16, 24, 24) over head_dim/2.
long_500k skipped (quadratic full attention).
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        activation="swiglu",
        stages=((("attn",), 80),),
        mrope_sections=(16, 24, 24),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke",
        family="vlm",
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation="swiglu",
        stages=((("attn",), 2),),
        mrope_sections=(2, 3, 3),
    )
