"""Unified model configuration (the port's copy of ``repro.models.config``).

A model is a token embedding, a sequence of *stages*, a final norm and an
LM head.  Each stage is a repeating *pattern* of block kinds — e.g.
recurrentgemma is ``(("rglru", "rglru", "local_attn"), 8)`` followed by
``(("rglru", "rglru"), 1)``.  Parameters of a stage are stacked on a
leading ``repeats`` axis, as in the JAX package, so weights carry across
leaf for leaf.

Block kinds (the port runs all of them):
  attn        pre-norm causal GQA self-attention + pre-norm FFN
  local_attn  as above with sliding-window attention
  enc_attn    bidirectional attention + FFN (encoder)
  dec_attn    causal self-attn + cross-attn to encoder + FFN (decoder)
  moe         attention + mixture-of-experts FFN (optionally shared experts)
  rglru       Griffin-style gated linear recurrent block + gated FFN
  mlstm       xLSTM matrix-memory block (chunkwise parallel)
  slstm       xLSTM scalar-memory block (sequential scan)

Of the JAX fields that steer tensor-parallel sharding, the port carries
``sequence_parallel`` (``blocks.apply_block``'s residual layout) and
``shard_vocab_embed`` (``sharding.specs``); ``matmul_reduce_dtype`` is
not carried: a DTensor product reduces its partial sums in its output's
dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Stage = Tuple[Tuple[str, ...], int]  # (pattern, repeats)

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; one of {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    impl: str = "dense"
    group_size: int = 0


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    stages: Tuple[Stage, ...]
    num_frames: int
    d_input: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    head_dim: int = 0  # 0 -> d_model // num_heads
    activation: str = "swiglu"  # swiglu | gelu | geglu
    norm_eps: float = 1e-6
    # positional encodings
    rope: bool = True
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # non-empty -> M-RoPE (qwen2-vl)
    # attention implementation: "full" or "blocked" (flash-style jnp path)
    attn_impl: str = "full"
    attn_block: int = 1024
    # sliding-window attention
    local_window: int = 2048
    # recurrence widths
    rnn_width: int = 0
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    mlstm_chunk: int = 256
    # encoder-decoder
    encoder: Optional[EncoderConfig] = None
    # MoE
    moe: Optional[MoEConfig] = None
    # numerics
    dtype: str = "bfloat16"      # compute dtype
    param_dtype: str = "float32"  # storage dtype
    logit_dtype: str = "float32"
    # Megatron-style sequence parallelism: in training the residual after
    # attention is laid out (B, S/tp, d) over the model dim
    sequence_parallel: bool = False
    # training
    remat: str = "dots"
    loss_chunk: int = 0
    loss_impl: str = "log_softmax"
    tie_embeddings: bool = False
    scan_layers: bool = True
    # True: the embedding's vocab dim shards over the model dim; False: its
    # d over the data dim (the token gather stays local)
    shard_vocab_embed: bool = True

    # ------------------------------------------------------------------
    @property
    def kq_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_layers(self) -> int:
        return sum(len(p) * r for p, r in self.stages)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def store_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
