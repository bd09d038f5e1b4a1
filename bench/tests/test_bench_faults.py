"""A run with its timed path broken underneath comes out not correct: the
harness driven on the CPU at smoke sizes (its look for a card skipped),
once for each fault a cell can have.  One chip, so no exchange between
chips to leave out; batch 1, so half of each sequence's tokens stands for
half of the batch."""
from __future__ import annotations

import pytest
import torch

from conftest import run_cell


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
