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
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_MODULES[name])
    return mod.smoke_config() if smoke else mod.full_config()
