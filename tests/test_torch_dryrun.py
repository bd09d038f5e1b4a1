"""The port's dry run (``repro_torch.launch.dryrun``) at a miniature
shape: smoke configs on the fake 256-rank production mesh, in a fresh
process (the fake group must not outlive it).  Every record key is
there, and a dense 2-layer prefill laid out over both mesh dims counts
exactly its closed-form FLOPs per device."""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

# the smoke configs under their full names, at miniature shapes (seq 32,
# as tests/test_dryrun_smoke.py stands them in for the assigned cells;
# the batch a multiple of the data ranks, 16 or 32: DTensor may split a
# product's flattened rows over an idle mesh dim, and cannot unflatten a
# batch that the split does not divide, ROADMAP §C)
_RUN = """
import sys
import repro_torch.configs as C
from repro_torch.launch import dryrun
C.SHAPES.update({
    "_train": dict(seq_len=32, global_batch=16, kind="train"),
    "_prefill": dict(seq_len=32, global_batch=16, kind="prefill"),
    "_decode": dict(seq_len=32, global_batch=32, kind="decode"),
    "_dense": dict(seq_len=32, global_batch=16, kind="prefill"),
})
dryrun.get_config = lambda arch: C.get_config(arch, smoke=True)
out = sys.argv[1]
for argv in (["--arch", "granite-3-8b", "--shape", "_train"],
             ["--arch", "recurrentgemma-2b", "--shape", "_train"],
             ["--arch", "recurrentgemma-2b", "--shape", "_prefill"],
             ["--arch", "dbrx-132b", "--shape", "_decode", "--mesh", "multi"],
             ["--arch", "granite-3-8b", "--shape", "_dense", "--variant", "dense",
              "--set", "num_heads=16", "--set", "num_kv_heads=16", "--set", "head_dim=8",
              "--set", "d_ff=256"]):
    try:
        dryrun.main(argv + ["--out", out, "--keep-trace"])
    except SystemExit as e:
        if e.code:
            raise
"""

KEYS = {"arch", "shape", "mesh", "strategy", "variant", "kind", "chips", "status", "trace_s",
        "flops_per_device", "bytes_per_device", "collective_per_device_bytes",
        "collective_raw_bytes", "collective_count", "collective_by_kind", "memory",
        "roofline", "model", "overrides", "trace_path", "op_histogram"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "dryrun.json"
    run = subprocess.run([sys.executable, "-c", _RUN, str(out)],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_text())


def test_every_record_is_ok_with_every_key(records):
    assert sorted(records) == [
        "dbrx-132b|_decode|multi|fsdp_tp|baseline",
        "granite-3-8b|_dense|single|fsdp_tp|dense",
        "granite-3-8b|_train|single|fsdp_tp|baseline",
        "recurrentgemma-2b|_prefill|single|fsdp_tp|baseline",
        "recurrentgemma-2b|_train|single|fsdp_tp|baseline",
    ]
    for key, r in records.items():
        assert set(r) == KEYS, key
        assert r["status"] == "ok"
        assert r["chips"] == (512 if r["mesh"] == "multi" else 256)
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert set(r["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                    "peak_bytes", "alias_bytes"}
        assert set(r["roofline"]) == {"t_compute_s", "t_memory_s", "t_collective_s",
                                      "dominant"}
        assert set(r["model"]) == {"params", "active_params", "model_flops_global",
                                   "traced_flops_global", "useful_flops_ratio"}
        assert os.path.exists(r["trace_path"])
    assert records["granite-3-8b|_train|single|fsdp_tp|baseline"]["collective_count"] > 0


@pytest.mark.parametrize("arch", ["granite-3-8b", "recurrentgemma-2b"])
def test_dots_remat_train_step_runs_on_meta_dtensors(records, arch):
    """The smoke configs train under ``remat="dots"`` (``recast_weights``
    registers nothing on meta): a train step on DTensors over the fake
    mesh, every parameter and moment updated in place."""
    from repro_torch.configs import get_config

    assert get_config(arch, smoke=True).remat == "dots"
    r = records[f"{arch}|_train|single|fsdp_tp|baseline"]
    assert r["status"] == "ok" and r["kind"] == "train"
    assert r["memory"]["alias_bytes"] > 0 and r["model"]["traced_flops_global"] > 0


def test_dense_prefill_flops_per_device_equal_closed_form(records):
    """granite's smoke model with 16 heads of 8, 16 KV heads and an FFN of
    256 (every split divides the model dim) at batch 16 (one row a data
    rank): each product and the causal attention split 256 ways."""
    r = records["granite-3-8b|_dense|single|fsdp_tp|dense"]
    b, s, d, h, hd, ff, v, layers = 16, 32, 64, 16, 8, 256, 512, 2
    t = b * s
    per_layer = (2 * t * d * 3 * h * hd          # q, k, v projections
                 + 4 * b * h * hd * s * (s + 1) // 2  # causal attention (K4)
                 + 2 * t * h * hd * d            # output projection
                 + 3 * 2 * t * d * ff)           # SwiGLU: in, gate, out
    total = layers * per_layer + 2 * b * d * v   # the last token's logits
    assert r["flops_per_device"] == pytest.approx(total / 256, rel=1e-12)


def test_slstm_recurrent_products_are_counted():
    """The sLSTM's per-step recurrent products, which XLA's cost analysis
    cannot see (JAX's dry run adds them analytically), are in the trace:
    the recorder's FLOPs of ``slstm_scan`` are its input and output
    projections plus JAX's analytic 2·tokens·4·d·hd, exactly."""
    import torch

    from repro_torch.launch.comm_stats import Recorder
    from repro_torch.layers import xlstm

    b, s, d, h = 2, 16, 32, 4
    hd = d // h
    params = xlstm.init_slstm(torch.Generator().manual_seed(0), d, h, torch.float32, "cpu")
    x = torch.randn(b, s, d, generator=torch.Generator().manual_seed(1))
    with Recorder() as rec:
        xlstm.slstm_scan(params, x, h, torch.float32)
    tokens = b * s
    assert rec.flops == 2 * tokens * d * 4 * d + 2 * tokens * 4 * d * hd + 2 * tokens * d * d


def test_all_runs_each_cell_in_a_process_of_its_own(tmp_path):
    """``--all`` (narrowed by ``--arch`` and ``--shape``) runs each cell in
    a fresh process, side by side, and gathers every record into
    ``--out``: whisper-tiny's full decode_32k on both fake meshes."""
    out = tmp_path / "all.json"
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--arch",
                          "whisper-tiny", "--shape", "decode_32k", "--mesh", "both", "--out",
                          str(out)], env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    records = json.loads(out.read_text())
    assert sorted(records) == ["whisper-tiny|decode_32k|multi|tp|baseline",
                               "whisper-tiny|decode_32k|single|tp|baseline"]
    for r in records.values():
        assert r["status"] == "ok" and r["kind"] == "decode"
        assert r["chips"] == (512 if r["mesh"] == "multi" else 256)
        assert r["flops_per_device"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["all.json"]  # the cells' parts are gone
