"""whisper-tiny [audio]: enc-dec, conv frontend STUB (precomputed frames).

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 [arXiv:2212.04356].
Adaptation note: decoder self-attention uses RoPE instead of Whisper's
learned absolute positions (assigned shapes reach 32k ≫ Whisper's 448-token
table); encoder keeps sinusoidal positions.  long_500k skipped (quadratic).
"""
from repro_torch.models.config import EncoderConfig, ModelConfig

NUM_FRAMES = 1500  # Whisper's 30 s @ 50 Hz post-conv frame count


def full_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        activation="gelu",
        stages=((("dec_attn",), 4),),
        encoder=EncoderConfig(stages=((("enc_attn",), 4),), num_frames=NUM_FRAMES, d_input=384),
        rope=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke",
        family="audio",
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        activation="gelu",
        stages=((("dec_attn",), 2),),
        encoder=EncoderConfig(stages=((("enc_attn",), 2),), num_frames=32, d_input=64),
        rope=True,
    )
