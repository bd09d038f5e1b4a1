"""Architecture registry of the port.

Every module exposes ``full_config()`` (the exact published dims) and
``smoke_config()`` (a reduced same-family config runnable on the CPU).
Only the architectures whose block kinds the port runs are listed.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_MODULES[name])
    return mod.smoke_config() if smoke else mod.full_config()
