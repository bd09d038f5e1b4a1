"""The dry run's collective model (``repro_torch.launch.comm_stats``)
against ``repro.launch.hlo_stats`` on the same four collectives, and the
dispatch-trace recorder on a fake 8-rank mesh."""
import json
import os
import subprocess
import sys

import pytest

from repro.launch.hlo_stats import collective_stats as jax_collective_stats
from repro_torch.launch.comm_stats import collective_stats, op_histogram

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_hlo_stats import SAMPLE  # noqa: E402

# SAMPLE's four collectives as the recorder writes them (per-device bytes)
RECORDS = [
    {"kind": "all-reduce", "operand_bytes": 512 * 256 * 4, "output_bytes": 512 * 256 * 4,
     "group": 4},
    {"kind": "all-gather", "operand_bytes": 8 * 128 * 2, "output_bytes": 64 * 128 * 2,
     "group": 8},
    {"kind": "reduce-scatter", "operand_bytes": 256 * 4, "output_bytes": 64 * 4, "group": 4},
    {"kind": "collective-permute", "operand_bytes": 16 * 4, "output_bytes": 16 * 4,
     "group": 0},
]


def test_ring_model_equals_hlo_stats():
    want = jax_collective_stats(SAMPLE, total_devices=8)
    got = collective_stats(RECORDS, total_devices=8)
    assert got.count == want.count == 4
    assert got.per_device_bytes == want.per_device_bytes
    assert got.raw_bytes == want.raw_bytes
    assert got.by_kind == want.by_kind


def test_op_histogram_counts_each_op():
    assert op_histogram(["aten.mm.default", "aten.add.Tensor", "aten.mm.default"]) == {
        "aten.mm.default": 2, "aten.add.Tensor": 1}


_RECORD = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.comm_stats import Recorder
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, [Shard(0), Shard(1)])
with Recorder() as rec:
    x.redistribute(mesh, [Replicate(), Replicate()])
gathers = sorted((r["group"], r["operand_bytes"], r["output_bytes"]) for r in rec.records)
y = distribute_tensor(torch.empty(64, 64, device="meta"), mesh, [Shard(0), Replicate()])
w = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, [Replicate(), Replicate()])
with Recorder() as mm:
    out = y @ w
print(json.dumps({"kinds": sorted({r["kind"] for r in rec.records}), "gathers": gathers,
                  "flops": mm.flops, "split": [str(p) for p in out.placements]}))
"""


def test_recorder_sees_a_redistribution_on_a_fake_mesh():
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", _RECORD], env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["kinds"] == ["all-gather"]
    # (64, 32) f32 split (2, 4) ways: an (32, 8) shard gathered over the
    # model dim's 4 ranks, then (32, 32) over the data dim's 2
    assert sorted(map(tuple, got["gathers"])) == [(2, 32 * 32 * 4, 64 * 32 * 4),
                                                  (4, 32 * 8 * 4, 32 * 32 * 4)]
    # the product's FLOPs per device: the global 2·64·64·32 over the
    # mesh dims its output is split on
    split = 1
    for p, n in zip(got["split"], (2, 4)):
        split *= 1 if p == "R" else n  # a Shard or Partial placement splits the work
    assert split >= 2
    assert got["flops"] == pytest.approx(2 * 64 * 64 * 32 / split)
