"""Fixtures of the benchmark's own tests: the harness on the CPU at smoke
sizes, through a benchmark root of its own in a temporary directory
(``BENCHMARK.json``, configuration files, mixes, limits; the metric
readers and reference modules copied from ``bench/metrics`` and
``bench/reference``)."""
from __future__ import annotations

import io
import json
import shutil
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_COMMON = {"rms_norm_eps": 1e-6, "rope_theta": 10000.0, "tie_word_embeddings": False,
                "torch_dtype": "float32", "compute_dtype": "bfloat16", "vocab_size": 512,
                "num_hidden_layers": 2, "port_smoke": True}
DENSE = dict(SMOKE_COMMON, name="dense-smoke", port_arch="granite-3-8b", hidden_size=64,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16, intermediate_size=160)
# granite-3-8b ties its embeddings; at d 64 the tied logits are too small
# for the serving limits below, so that cell keeps an lm_head of its own
TIED = dict(DENSE, name="tied-smoke", tie_word_embeddings=True)
MOE = dict(SMOKE_COMMON, name="moe-smoke", port_arch="qwen2-moe-a2.7b", hidden_size=64,
           num_attention_heads=4, num_key_value_heads=4, head_dim=16, moe_intermediate_size=64,
           shared_expert_intermediate_size=128, num_experts=6, num_experts_per_tok=2,
           capacity_factor=1.25, router_aux_loss_coef=0.01, norm_topk_prob=True)
# Limits at these sizes, set on this CPU from 8 seeds of the program and
# 3 of the float8 control (program max / control min): loss 6.3e-4 /
# 3.8e-3, gradient 4.1e-3 / 1.25e-2, change 1.9e-3 / 4.2e-3 (the fault of
# half the tokens: 0.23); served logit gap 0.018 / 0.106.
TRAIN_LIMITS = {"loss_gap": 1.8e-3, "grad_gap": 8e-3, "update_gap": 0.02}
# The MoE's limits by the same rule, with its reference routed as the
# program routed (PERF.md §2).  On this CPU, 12 seeds of the program and 6
# of the float8 control, each held against the float32 reference routed by
# its own routes (program max / control min): loss 6.7e-4 / 1.6e-3,
# gradient 4.5e-3 / 2.0e-2, change 1.3e-3 / 3.6e-3, route_gap 0 / 0.029;
# the fault of half the tokens: loss 1.4e-2, change 2.3e-2 (least of 3),
# route_gap 0 on 6 (so the control's is route_gap's upper reading).
MOE_TRAIN_LIMITS = {"loss_gap": 2e-3, "grad_gap": 1e-2, "update_gap": 5e-3, "route_gap": 0.01}
SERVE_LIMITS = {"served_logit_gap": 0.06}


def _mixes():
    train = json.loads((BENCH / "traffic" / "train-4k.json").read_text())
    train.update(records=64, seq_len=32, trace_seconds=1)
    serve = json.loads((BENCH / "traffic" / "serve-docqa.json").read_text())
    serve.update(max_batch=4, prompt_capacity=64, max_new_tokens=8, rate_per_s=4.0,
                 prompt_len={"median": 16, "sigma": 0.7, "min": 4, "max": 64},
                 gen_len={"min": 2, "max": 8}, sample_served_tokens=30, trace_seconds=1,
                 drain_seconds=20)
    return {"train-smoke": train, "serve-smoke": serve}


def make_root(tmp: Path) -> Path:
    """A benchmark root at smoke sizes: cells ``dense.train``,
    ``tied.train``, ``moe.train`` and ``dense.serve``, the real metrics."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "bench" / "configs").mkdir(parents=True)
    for sub in ("traffic", "limits"):
        (tmp / "bench" / sub).mkdir()
    for sub in ("metrics", "reference"):
        shutil.copytree(BENCH / sub, tmp / "bench" / sub, ignore=shutil.ignore_patterns("__pycache__"))
    for conf in (DENSE, TIED, MOE):
        (tmp / "bench" / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
    for name, mix in _mixes().items():
        (tmp / "bench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = {"dense.train": ("dense-smoke", "train-smoke", TRAIN_LIMITS),
             "tied.train": ("tied-smoke", "train-smoke", TRAIN_LIMITS),
             "moe.train": ("moe-smoke", "train-smoke", MOE_TRAIN_LIMITS),
             "dense.serve": ("dense-smoke", "serve-smoke", SERVE_LIMITS)}
    for cell, (_, _, lim) in cells.items():
        (tmp / "bench" / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    spec["configs"] = [{"name": c["name"], "source": "smoke", "file": f"bench/configs/{c['name']}.json",
                        "reduced": [], "why": "smoke"} for c in (DENSE, TIED, MOE)]
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "smoke"}
                         for n, (c, t, _) in cells.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            serving = any("serve" in w for w in m["workloads"])
            m["workloads"] = (["dense.serve"] if serving
                              else ["dense.train", "tied.train", "moe.train"])
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


@pytest.fixture
def smoke_root(tmp_path):
    return make_root(tmp_path / "root")


def run_cell(root: Path, cell: str, seed: int = 1234567891234, seconds: float = 2.0,
             trace: int = 0):
    """``bench/run.py`` on the CPU: ``(exit code, the result's line or
    None, standard error)``."""
    import torch

    import run

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=torch.device("cpu"), root=root,
                      bench=root / "bench")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
