"""Input specs for every (arch × shape) cell: tensors on the meta device
with the shapes and dtypes of ``repro.launch.input_specs``'s
``ShapeDtypeStruct``s, made by the port's own ``init_train_state``,
``init_params`` and ``init_decode_cache`` on ``torch.device("meta")``.

No memory is allocated here: the dry run (:mod:`repro_torch.launch.dryrun`)
lays these tensors out on the production mesh and traces a step over
them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamW
from repro_torch.train.steps import init_train_state

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "tokens": _spec((batch, seq), torch.int32),
        "labels": _spec((batch, seq), torch.int32),
    }
    specs.update(extras_specs(cfg, batch, seq))
    return specs


def extras_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    ex: Dict[str, Any] = {}
    if cfg.encoder is not None:
        ex["encoder_frames"] = _spec(
            (batch, cfg.encoder.num_frames, cfg.encoder.d_input), torch.float32
        )
    if cfg.mrope_sections:
        ex["positions_3d"] = _spec((batch, 3, seq), torch.int32)
    return ex


def state_specs(cfg: ModelConfig, optimizer: Optional[AdamW] = None):
    return init_train_state(cfg, None, optimizer or AdamW(), META)


def params_specs(cfg: ModelConfig):
    return M.init_params(cfg, None, META)


def cache_specs(cfg: ModelConfig, batch: int, capacity: int):
    return M.init_decode_cache(cfg, batch, capacity, META, pos=0)


def input_specs(cfg: ModelConfig, shape_name: str, optimizer: Optional[AdamW] = None):
    """Returns (kind, args_tuple_of_specs) for the cell's step function.

    train   -> (state, batch)
    prefill -> (params, tokens, extras)
    decode  -> (params, cache, tokens, extras)   # one token @ pos=seq-1
    """
    sh = SHAPES[shape_name]
    b, seq, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    if kind == "train":
        return "train", (state_specs(cfg, optimizer), batch_specs(cfg, b, seq))
    if kind == "prefill":
        return "prefill", (
            params_specs(cfg),
            _spec((b, seq), torch.int32),
            extras_specs(cfg, b, seq),
        )
    # decode: a KV cache of seq_len; the new token is written at seq_len-1
    extras = {}
    if cfg.mrope_sections:
        extras["positions_3d"] = _spec((b, 3, 1), torch.int32)
    return "decode", (
        params_specs(cfg),
        cache_specs(cfg, b, seq),
        _spec((b, 1), torch.int32),
        extras,
    )
