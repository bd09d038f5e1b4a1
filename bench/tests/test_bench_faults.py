"""A run with its timed path broken underneath comes out not correct: the
harness driven on the CPU at smoke sizes (its look for a card skipped),
once for each fault a cell can have.  One chip, so no exchange between
chips to leave out; batch 1, so half of each sequence's tokens stands for
half of the batch.  A MoE step besides: routes altered where they are
produced, a recompute that routes otherwise, an expert's weights
swapped."""
from __future__ import annotations

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import MOE, run_cell


def _checks(result):
    return {k: v["value"] > v["limit"] for k, v in result["checks"].items()}


def test_a_step_that_leaves_its_state_unchanged(smoke_root, monkeypatch):
    from repro_torch.train.optimizer import AdamW

    def unchanged(self, grads, state, params):
        z = torch.zeros(())
        return {"grad_norm": z, "lr": z}

    monkeypatch.setattr(AdamW, "update", unchanged)
    rc, result, _ = run_cell(smoke_root, "dense.train", seconds=1)
    assert rc == 0 and not result["correct"]
    assert _checks(result)["update_gap"]


def test_half_of_the_tokens_left_out(smoke_root, monkeypatch):
    from repro_torch.models import model as M

    full = M.loss_fn

    def half(cfg, params, batch, ctx=None):
        labels = batch["labels"].clone()
        labels[:, labels.shape[1] // 2:] = -1  # the mean over the rest
        return full(cfg, params, dict(batch, labels=labels), ctx)

    monkeypatch.setattr(M, "loss_fn", half)
    rc, result, _ = run_cell(smoke_root, "dense.train", seconds=1)
    assert rc == 0 and not result["correct"]


def test_a_token_altered_where_the_batch_is_made(smoke_root, monkeypatch):
    from repro_torch.data import synthetic

    decode = synthetic.decode_token_batch

    def altered(raws, seq_len):
        out = decode(raws, seq_len)
        out["tokens"] = out["tokens"].copy()
        out["tokens"][0, 3] = (out["tokens"][0, 3] + 1) % 512
        return out

    monkeypatch.setattr(synthetic, "decode_token_batch", altered)
    rc, result, _ = run_cell(smoke_root, "dense.train", seconds=1)
    assert rc == 0 and not result["correct"]
    assert _checks(result)["batches_unlike_corpus"]


def test_a_served_token_altered_where_it_is_produced(smoke_root, monkeypatch):
    from repro_torch.models import model as M

    step = M.decode_step

    def altered(cfg, params, cache, tokens, extras=None, ctx=None):
        cache, logits = step(cfg, params, cache, tokens, extras, ctx)
        logits = logits.clone()
        logits[:, 7] += 1e4  # every row now emits token 7
        return cache, logits

    monkeypatch.setattr(M, "decode_step", altered)
    rc, result, _ = run_cell(smoke_root, "dense.serve", seconds=2)
    assert rc == 0 and not result["correct"]
    assert _checks(result)["served_logit_gap"]


# --------------------------------------------------- MoE routing faults


class _TopK(TorchDispatchMode):
    """The program's router's top k altered where it is produced: the
    ``alter(call, values, indices, probs)`` of every top k of the smoke
    MoE's ``k`` over its experts, ``call`` counting them from 0.  On the
    whole ``Trainer.train``, so that it lies under the harness's recorder
    and the reference (run after ``train``) is left alone."""

    def __init__(self, alter):
        super().__init__()
        self.alter, self.calls = alter, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.topk.default and args[1] == MOE["num_experts_per_tok"] \
                and args[0].shape[-1] == MOE["num_experts"]:
            out = self.alter(self.calls, *out, args[0])
            self.calls += 1
        return out


def _next_best(values, indices, probs, rows):
    """The next-best k experts in place of the top k on ``rows`` of the
    tokens (a boolean mask over the last but one dim)."""
    k = indices.shape[-1]
    nv, ni = torch.topk(probs, 2 * k, dim=-1)
    m = rows[..., None]
    return torch.where(m, nv[..., k:], values), torch.where(m, ni[..., k:], indices)


def _in_training(monkeypatch, alter):
    from repro_torch.train.loop import Trainer

    train = Trainer.train

    def altered(self):
        with _TopK(alter):
            return train(self)

    monkeypatch.setattr(Trainer, "train", altered)


def test_routes_from_the_next_best_experts_fail_route_gap(smoke_root, monkeypatch):
    """Every third token routed to its next-best k experts: the forced
    reference follows the program there, so the loss can look sound; the
    routes cannot."""
    def alter(call, values, indices, probs):
        rows = torch.arange(indices.shape[-2]) % 3 == 0
        return _next_best(values, indices, probs, rows)

    _in_training(monkeypatch, alter)
    rc, result, _ = run_cell(smoke_root, "moe.train", seconds=1)
    assert rc == 0 and not result["correct"]
    assert _checks(result)["route_gap"]


def test_a_recompute_that_routes_otherwise(smoke_root, monkeypatch):
    """Under remat "dots" a step of the smoke MoE's 2 layers routes 4
    times: 2 forwards, then the 2 recomputes of the backward.  The
    recomputes take the next-best experts: the gradients are another
    function's."""
    def alter(call, values, indices, probs):
        if call % 4 < 2:
            return values, indices
        return _next_best(values, indices, probs, torch.ones(indices.shape[:-1], dtype=torch.bool))

    _in_training(monkeypatch, alter)
    rc, result, _ = run_cell(smoke_root, "moe.train", seconds=1)
    assert rc == 0 and not result["correct"]
    assert _checks(result)["route_recompute_mismatch"]
    assert result["checks"]["route_recompute_mismatch"]["value"] == 6  # 2 a step, 3 steps


def test_an_experts_weights_swapped_with_routes_forced(smoke_root, monkeypatch):
    """Expert 0's ``w_in`` and ``w_gate`` swapped in the program's tree:
    routed as the program routes, the reference still sees another
    function (forcing the routes does not blind the check)."""
    from harness import weights

    fill = weights.fill_port

    def swapped(ref, cfg, seed, tree):
        fill(ref, cfg, seed, tree)
        moe = tree["stages"][0][0]["moe"]
        with torch.no_grad():
            w_in = moe["w_in"][:, 0].clone()
            moe["w_in"][:, 0] = moe["w_gate"][:, 0]
            moe["w_gate"][:, 0] = w_in

    monkeypatch.setattr(weights, "fill_port", swapped)
    rc, result, _ = run_cell(smoke_root, "moe.train", seconds=1)
    assert rc == 0 and not result["correct"]
    failed = _checks(result)
    assert failed["loss_gap"] or failed["grad_gap"], result["checks"]
