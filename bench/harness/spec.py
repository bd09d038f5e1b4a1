"""What a run is made of, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is ``configs`` entry's ``file``; its
reference is ``bench/reference/<module>.py`` for the file's
``"reference"`` key (default ``lm``), which gives the plain model, its
leaves and where the program holds them, and the widths ``port_config``
checks (``reference/lm.py``'s docstring lists what a module provides); the
mix is ``bench/traffic/<traffic>.json``, whose ``generator`` names the
module that reads it (``train`` or ``serve``); the limits of the cell's
output check are ``bench/limits/<cell>.json``; a per-layer metric ``<m>``
is read by ``bench/metrics/<m>.py``'s ``read(run)``.  Adding any of them,
a new architecture with its own reference module included, takes new files
and entries only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    reference: ModuleType

    @property
    def generator(self) -> str:
        return self.mix["generator"]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell_name: str, root: Path, bench: Optional[Path] = None) -> Cell:
    """The cell ``cell_name`` of ``root/BENCHMARK.json``; its mix, limits
    and metric readers come from ``bench`` (default: this directory)."""
    bench = bench or BENCH
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; one of {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{cell_name}.json").read_text())
    return Cell(
        name=cell_name, chips=int(w["chips"]), config=config, mix=mix, limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, cell_name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, cell_name)],
        reference=reference(config, bench))


def _load(path: Path, prefix: str) -> ModuleType:
    mod_name = prefix + "".join(c if c.isalnum() else "_" for c in str(path))
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench: Optional[Path] = None) -> Callable:
    """``read(run)`` of ``bench/metrics/<metric>.py``."""
    return _load((bench or BENCH) / "metrics" / f"{metric}.py", "bench_metric_").read


_REFERENCES: Dict[Path, ModuleType] = {}


def reference(config: Dict, bench: Optional[Path] = None) -> ModuleType:
    """The configuration's reference module, ``bench/reference/<name>.py``
    for its ``"reference"`` key (``lm`` where it has none), loaded once."""
    name = config.get("reference", "lm")
    if not re.fullmatch(r"[A-Za-z0-9_]{1,64}", name):
        raise ValueError(f"{config['name']}: reference {name!r} is no module name")
    path = ((bench or BENCH) / "reference" / f"{name}.py").resolve()
    if path not in _REFERENCES:
        _REFERENCES[path] = _load(path, "bench_reference_")
    return _REFERENCES[path]


def port_config(config: Dict, remat: str = "dots", ref: Optional[ModuleType] = None):
    """The program's ``ModelConfig`` for a configuration file: the port's
    registry entry ``port_arch`` (or its smoke entry, ``port_smoke``) at the
    file's depth; refused where a width that the reference module ``ref``
    (default: the file's own, ``reference``) names differs."""
    from repro_torch.configs import get_config

    cfg = get_config(config["port_arch"], smoke=bool(config.get("port_smoke")))
    (pattern, _), = cfg.stages
    cfg = cfg.replace(name=config["name"], stages=((pattern, config["num_hidden_layers"]),),
                      remat=remat, param_dtype=config["torch_dtype"],
                      dtype=config["compute_dtype"], norm_eps=config["rms_norm_eps"],
                      rope_theta=config["rope_theta"],
                      tie_embeddings=bool(config["tie_word_embeddings"]))
    have = {}
    for key, attr in (ref or reference(config)).port_widths(config).items():
        v = cfg
        for part in attr.split("."):
            v = getattr(v, part, None)
        have[key] = v
    wrong = {k: (v, config.get(k)) for k, v in have.items() if config.get(k) != v}
    if wrong:
        raise ValueError(f"{config['name']}: the port's configuration differs (port, file): {wrong}")
    return cfg
