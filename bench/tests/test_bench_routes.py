"""A MoE step checked on the program's own routes: the recorder is on for
the check steps only, and the forced reference reads the routes the
program took."""
from __future__ import annotations

import numpy as np
import torch

from conftest import DENSE, MOE, run_cell
from harness import routes, spec, train
from reference import lm


def test_the_recorder_is_off_in_the_window(smoke_root, monkeypatch):
    """Every routing call the recorder sees belongs to a check step: 3
    steps of 2 layers, each routed in the forward and again in the
    backward's recompute; the window's steps add none."""
    seen = []
    dispatch = routes.Recorder.__torch_dispatch__

    def counted(self, func, types, args=(), kwargs=None):
        if func is routes.TOPK and args[1] == MOE["num_experts_per_tok"]:
            seen.append(len(self.steps))
        return dispatch(self, func, types, args, kwargs)

    monkeypatch.setattr(routes.Recorder, "__torch_dispatch__", counted)
    rc, result, err = run_cell(smoke_root, "moe.train", seconds=1)
    assert rc == 0 and result["correct"], err[-2000:]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert sorted(seen) == [1] * 4 + [2] * 4 + [3] * 4


def test_the_reference_follows_the_routes_it_is_given(smoke_root):
    """Routed by the control's own routes, the float32 reference reads
    every pair as the control's and counts none of its own top k as
    outside; routed by other experts (each id moved on by k), it counts
    most pairs outside its top k."""
    cell = spec.load("moe.train", smoke_root, smoke_root / "bench")
    ids = [np.array([i]) for i in np.random.default_rng(4).permutation(cell.mix["records"])[:3]]
    cpu = torch.device("cpu")
    own = train.reference_readings(cell, 4, cpu, ids)
    again = train.reference_readings(cell, 4, cpu, ids, routes=own["routes"])
    assert again["losses"] == own["losses"] and again["grad_norms"] == own["grad_norms"]
    assert again["route_outside"] == 0
    pairs = len(ids) * MOE["num_hidden_layers"] * cell.mix["seq_len"] * MOE["num_experts_per_tok"]
    assert again["route_pairs"] == pairs
    worse = [{l: (r + MOE["num_experts_per_tok"]) % MOE["num_experts"] for l, r in step.items()}
             for step in own["routes"]]
    off = train.reference_readings(cell, 4, cpu, ids, routes=worse)
    assert off["route_outside"] > 0.5 * pairs


def test_routes_are_kept_by_the_layers_the_reference_names():
    """A model whose layers 1 and 3 route, and 0 and 2 do not: each step's
    forward calls are kept under those layers' numbers, and a recompute
    (last layer first) that routes otherwise is counted."""
    a, b = torch.zeros(1, 4, 2, dtype=torch.long), torch.ones(1, 4, 2, dtype=torch.long)
    rec = routes.Recorder(experts=6, k=2)
    rec.steps = [[a, b, b, a], [a, b, a, a]]
    kept, mismatch = rec.split([1, 3], recomputed=True)
    assert [sorted(step) for step in kept] == [[1, 3], [1, 3]]
    assert torch.equal(kept[0][1], a) and torch.equal(kept[0][3], b)
    assert mismatch == 1
    assert lm.moe_layers(MOE) == [0, 1] and lm.moe_layers(DENSE) == []
