"""Architecture registry of the port.

Every module exposes ``full_config()`` (the exact published dims) and
``smoke_config()`` (a reduced same-family config runnable on the CPU).
All ten of the JAX package's architectures are listed.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_MODULES[name])
    return mod.smoke_config() if smoke else mod.full_config()


# Shape cells assigned to the LM-family pool (all archs share these).
SHAPES: Dict[str, dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k requires sub-quadratic sequence mixing.
SUBQUADRATIC = {"recurrentgemma-2b", "xlstm-1.3b"}


def cell_is_runnable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True


def all_cells():
    return [
        (a, s) for a in ARCH_IDS for s in SHAPES if cell_is_runnable(a, s)
    ]
