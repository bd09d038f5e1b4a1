"""``attn_share.train``: the training attention kernels' device seconds over
the traced span's busy seconds, read from a trace's kernel names; None
where none of them ran, as on a program whose training attention is the
masked sdpa, and in a serving run."""
from __future__ import annotations

import pytest

from conftest import run_cell
from harness import profile, spec

NS = 1_000_000  # a millisecond


def _trace(device):
    return profile.Trace(device=device, host=[], start=0, end=100 * NS)


def _run(kind, device):
    return {"kind": kind, "trace": _trace(device)}


def test_it_reads_the_forward_and_backward_kernels_over_busy_time():
    read = spec.reader("attn_share.train")
    device = [
        ("void repro_torch::fa_wgmma::fa_train_fwd_kernel<128>(CUtensorMap)", 0, 10 * NS),
        ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT", 10 * NS, 20 * NS),
        ("void repro_torch::fa_wgmma::fa_bwd_delta_kernel(bf16 const*)", 40 * NS, 2 * NS),
        ("void repro_torch::fa_wgmma::fa_bwd_dq_kernel<128>(CUtensorMap)", 42 * NS, 8 * NS),
        ("void repro_torch::fa_wgmma::fa_bwd_kv_kernel<128>(CUtensorMap)", 50 * NS, 10 * NS),
    ]
    # 30 ms of the kernels over 50 ms busy (the idle 30-40 ms and 60-100 ms left out)
    assert read(_run("train", device)) == pytest.approx(60.0)


@pytest.mark.parametrize("kind,names", [
    ("train", ["void at::native::elementwise_kernel<128, 2>", "cunn_SoftMaxForward"]),
    ("serve", ["void repro_torch::fa_wgmma::fa_wgmma_kernel<128>(CUtensorMap)"]),
    ("serve", ["void repro_torch::fa_wgmma::fa_train_fwd_kernel<128>(CUtensorMap)"]),
])
def test_it_reads_none_without_the_training_kernels_or_outside_training(kind, names):
    read = spec.reader("attn_share.train")
    assert read(_run(kind, [(n, i * NS, NS) for i, n in enumerate(names)])) is None
    assert read({"kind": "train", "trace": None}) is None


def test_a_traced_training_run_on_the_cpu_leaves_it_out(smoke_root):
    """The plain route (the CPU's) runs no training kernel: the line lacks
    the metric, as the parent's does on the card."""
    rc, result, err = run_cell(smoke_root, "dense.train", seconds=1, trace=1)
    assert rc == 0 and result["correct"], err
    assert "device_idle_share.train" in result["metrics"]
    assert "attn_share.train" not in result["metrics"]
