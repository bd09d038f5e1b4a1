"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric loads by name, the names keep to the contract's characters,
and a new cell needs only new files."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import BENCH, ROOT, run_cell
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = spec.load(cell, ROOT)
    assert c.generator in ("train", "serve")
    cfg = spec.port_config(c.config)
    assert cfg.num_layers == c.config["num_hidden_layers"]
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(c.end_to_end) >= 3 and c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert set(c.limits) <= {"loss_gap", "grad_gap", "update_gap", "route_gap",
                             "served_logit_gap"}


def test_names_units_and_whys_keep_to_the_contract():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf and conf[key] != conf["published"].get(key)
    for m in SPEC["end_to_end"]:
        assert 0 < m["bound"] <= 0.25


def test_a_new_cell_needs_only_new_files(tmp_path, smoke_root):
    """A throwaway cell from a temporary directory: a configuration file, a
    mix, limits and a per-layer metric reader, all new files, and new
    entries in BENCHMARK.json."""
    root = smoke_root
    b = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "bench" / "configs" / "dense-smoke.json").read_text())
    conf["name"], conf["num_hidden_layers"] = "dense-smoke-1l", 1
    (root / "bench" / "configs" / "dense-smoke-1l.json").write_text(json.dumps(conf))
    mix = json.loads((root / "bench" / "traffic" / "train-smoke.json").read_text())
    mix["seq_len"] = 16
    (root / "bench" / "traffic" / "train-short.json").write_text(json.dumps(mix))
    shutil.copy(root / "bench" / "limits" / "dense.train.json",
                root / "bench" / "limits" / "extra.train.json")
    (root / "bench" / "metrics" / "steps_done.train.py").write_text(
        "def read(run):\n    return float(run['steps']) if run['kind'] == 'train' else None\n")
    b["configs"].append({"name": "dense-smoke-1l", "source": "smoke", "reduced": [], "why": "x",
                         "file": "bench/configs/dense-smoke-1l.json"})
    b["workloads"].append({"name": "extra.train", "config": "dense-smoke-1l",
                           "traffic": "train-short", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "steps_done.train", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "Loop and input",
                           "moves": "train_tokens_per_s", "workloads": ["extra.train"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "dense.train" in m["workloads"]:
            m["workloads"].append("extra.train")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    rc, result, _ = run_cell(root, "extra.train", seconds=1, trace=1)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["steps_done.train"]["value"] >= 1
    assert "mfu.train" in result["metrics"]


def _checks(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def test_a_new_reference_needs_only_new_files(smoke_root):
    """A configuration that names its own reference module: a copy of
    ``lm.py`` under another name, its configuration, limits and cells for
    training and serving, all new files and entries.  The copy's training
    check reads what ``lm``'s reads (serving's sample of requests hangs on
    the wall clock); a copy with its products changed makes the run not
    correct, so the named module is the one that ran."""
    root = smoke_root
    ref_dir = root / "bench" / "reference"
    lm = (ref_dir / "lm.py").read_text()
    (ref_dir / "lm_twin.py").write_text(lm)
    (ref_dir / "lm_off.py").write_text(lm.replace("        return a @ b\n",
                                                  "        return (a @ b) * 1.01\n"))
    b = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "bench" / "configs" / "dense-smoke.json").read_text())
    for module in ("lm_twin", "lm_off"):
        c = dict(conf, name=f"dense-{module}", reference=module)
        (root / "bench" / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
        b["configs"].append({"name": c["name"], "source": "smoke", "reduced": [], "why": "x",
                             "file": f"bench/configs/{c['name']}.json"})
        for kind, traffic in (("train", "train-smoke"), ("serve", "serve-smoke")):
            cell = f"{module}.{kind}"
            shutil.copy(root / "bench" / "limits" / f"dense.{kind}.json",
                        root / "bench" / "limits" / f"{cell}.json")
            b["workloads"].append({"name": cell, "config": c["name"], "traffic": traffic,
                                   "chips": 1, "why": "x"})
            for m in b["end_to_end"] + b["per_layer"]:
                if "workloads" in m and f"dense.{kind}" in m["workloads"]:
                    m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    assert spec.reference(conf, root / "bench").__file__ == str((ref_dir / "lm.py").resolve())
    rc, want, _ = run_cell(root, "dense.train", seconds=1)
    got = {}
    for kind in ("train", "serve"):
        rc_twin, got[kind], err = run_cell(root, f"lm_twin.{kind}", seconds=1)
        assert rc == rc_twin == 0 and got[kind]["correct"], err[-2000:]
    assert _checks(got["train"]) == _checks(want)
    rc, off, _ = run_cell(root, "lm_off.train", seconds=1)
    assert rc == 0 and not off["correct"]


def test_no_card_no_result(smoke_root, capsys):
    """Without as many CUDA devices as the cell asks for, the run exits
    with another code than 0 and prints no result."""
    import torch

    import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "dense.train", "--seed", "1", "--seconds", "1"],
                  root=smoke_root, bench=smoke_root / "bench")
    assert rc != 0 and capsys.readouterr().out == ""


def test_every_seed_gets_the_same_arrivals_in_another_order():
    """The serving mix: as many requests, the same set of gaps, prompt and
    generation lengths for every seed; the seed draws their order."""
    import numpy as np

    from harness import serve

    mix = spec.load("granite-3-8b.serve-docqa", ROOT).mix
    runs = [serve.schedule(mix, s, 50.0, 49155) for s in (1, 2, 2 ** 31 + 11)]
    for key in ("gaps", "prompt", "gen"):
        got = []
        for reqs in runs:
            due = np.array([r["due"] for r in reqs])
            got.append({"gaps": np.diff(due, prepend=0.0), "gen": [r["gen"] for r in reqs],
                        "prompt": [len(r["prompt"]) for r in reqs]}[key])
        assert len(got[0]) == int(mix["rate_per_s"] * 50.0)
        for other in got[1:]:
            np.testing.assert_allclose(np.sort(other), np.sort(got[0]), rtol=1e-12)
            assert not np.array_equal(other, got[0]), key


def test_the_recorder_reads_every_decode_row(smoke_root):
    """Every decode step's rows, read from the engine's public state after
    each step: a request of prompt p and g new tokens attends p + 1, ...,
    p + g - 1 positions in its g - 1 decode steps."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.request import Request

    from harness import serve

    cell = spec.load("dense.serve", smoke_root, smoke_root / "bench")
    conf, mix = cell.config, cell.mix
    cfg = spec.port_config(conf)
    params = serve._port_params(cfg, conf, 5, torch.device("cpu"), cell.reference)
    clock = serve.WallClock()
    engine = ServeEngine(cfg, params, max_batch=mix["max_batch"],
                         prompt_capacity=mix["prompt_capacity"],
                         max_new_tokens=mix["max_new_tokens"], clock=clock)
    reqs = serve.schedule(mix, 5, 2.0, conf["vocab_size"])
    rec = serve.Recorder(engine, clock, reqs)
    for r in reqs:
        engine.submit(Request(rid=r["rid"], prompt=r["prompt"], max_new_tokens=r["gen"]))
    while engine.queue or engine.slots:
        rec.step()
    got = sorted(x for rows, _ in rec.decodes for x in rows)
    want = sorted(len(r["prompt"]) + t for r in reqs for t in range(1, r["gen"]))
    assert got == want
    assert sorted(rec.first) == sorted(r["rid"] for r in reqs)
    assert sorted(rid for rid, _ in rec.admitted) == sorted(rec.first)
