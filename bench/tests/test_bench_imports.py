"""Nothing a run loads is JAX or the JAX package ``repro``, compared by
whole top-level names."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from conftest import BENCH, ROOT
from harness import common


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro" in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.x", sys)
    assert {"repro", "jaxlib"} <= set(common.forbidden_modules())


def test_a_run_loads_neither_jax_nor_repro(tmp_path):
    """A whole smoke run in a fresh interpreter, then its modules."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(ROOT / 'src')!r}]
        from pathlib import Path
        import conftest
        root = conftest.make_root(Path({str(tmp_path)!r}) / "root")
        rc, result, _ = conftest.run_cell(root, "dense.train", seconds=1)
        top = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"rc": rc, "correct": result["correct"], "top": top}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["rc"] == 0 and r["correct"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(r["top"])
    assert "repro_torch" in r["top"]


def test_a_module_loaded_after_the_window_withholds_the_result(smoke_root):
    """The guard runs last, after the check and the metric readers: a
    reader that loads ``jaxlib`` leaves the run with no result."""
    from conftest import run_cell

    spec = json.loads((smoke_root / "BENCHMARK.json").read_text())
    (smoke_root / "bench" / "metrics" / "loads_jaxlib.train.py").write_text(
        "import sys, types\n\n\ndef read(run):\n"
        "    sys.modules.setdefault('jaxlib', types.ModuleType('jaxlib'))\n    return None\n")
    spec["per_layer"].append({"name": "loads_jaxlib.train", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "Step",
                              "moves": "train_tokens_per_s", "workloads": ["dense.train"]})
    (smoke_root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert "jaxlib" not in sys.modules
    try:
        rc, result, err = run_cell(smoke_root, "dense.train", seconds=1, trace=1)
    finally:
        sys.modules.pop("jaxlib", None)
    assert rc != 0 and result is None
    assert "jaxlib" in err
