"""The per-layer metrics read from the program's own spans: a traced
serving run prints them, each agrees with what the harness counts itself,
and a training run prints none of them."""
from __future__ import annotations

import pytest

from conftest import run_cell

SPAN_METRICS = ("step_idle_share.serve", "queue_wait_ms.serve", "decode_launch_ms.serve",
                "prefill_pad_share.serve")


def test_a_traced_serving_run_reads_the_programs_spans(smoke_root, monkeypatch):
    from harness import serve

    runs = []
    real = serve.run

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        runs.append(out["run"])
        return out

    monkeypatch.setattr(serve, "run", keep)
    rc, result, err = run_cell(smoke_root, "dense.serve", trace=1)
    assert rc == 0 and result["correct"], err
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SPAN_METRICS) <= set(m)
    (run,) = runs
    lengths, cap = run["traced_prefills"], run["mix"]["prompt_capacity"]
    assert lengths
    assert m["prefill_pad_share.serve"] == pytest.approx(
        100.0 * sum(cap - n for n in lengths) / (cap * len(lengths)), rel=1e-12)
    assert m["queue_wait_ms.serve"] >= 0.0
    assert 0.0 <= m["step_idle_share.serve"] <= m["device_idle_share.serve"]
    assert m["decode_launch_ms.serve"] > 0.0


def test_a_traced_training_run_reads_none_of_them(smoke_root):
    rc, result, err = run_cell(smoke_root, "dense.train", seconds=1, trace=1)
    assert rc == 0 and result["correct"], err
    assert "device_idle_share.train" in result["metrics"]
    assert not set(SPAN_METRICS) & set(result["metrics"])
