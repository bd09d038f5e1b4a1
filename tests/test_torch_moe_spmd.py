"""The dense MoE and the embedding laid out as JAX's spec rules lay them
out, against the unsharded port and JAX, on the CPU.

* The embedding on 4 gloo ranks as a (2, 2) ``("data", "model")`` mesh
  (``tests/_torch_dist.py``): the table's d over ``data``, or its vocab
  over ``model`` and its d over ``data`` (``shard_vocab_embed``), each
  rank gathering from its own shard.  The rows and the table's gradient
  equal the plain ``w[ids]``'s bit for bit in f32.
* One train step, a prefill and two teacher-forced decode steps of
  qwen2-moe-a2.7b's smoke model in f32 (``impl="dense"``) on the same
  mesh, with 6 experts (split over ``model``) and with 5 (``model`` does
  not divide them: the expert-ff dim is split instead), from JAX's
  ``init_params`` carried across by ``params_from_jax``.  The loss, the
  gradients (read from AdamW's first moments, as
  ``tests/test_torch_spmd.py`` reads xlstm's) and the logits are held to
  1e-5 (of each leaf's largest entry) against the unsharded port, and the
  loss also against JAX's ``loss_fn`` on the same weights and batch.
* The dry run of qwen2-moe-a2.7b's and dbrx-132b's full configs, cut to
  one layer, training at seq 128 and batch 256 on the fake 256-rank
  mesh, in a fresh process: both cells are ``ok`` (qwen2-moe-a2.7b's 60
  experts on a 16-rank ``model`` dim failed to flatten their gradient).

The embedding and MoE cases share one spawn of the gloo ranks, and the
dry run's process runs beside them.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_dist import _spmd_step_rank, run_ranks
from repro.configs import get_config as jax_config
from repro.models import model as jm
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax
from repro_torch.train.optimizer import AdamW
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_map

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
B, S, PROMPT, DECODE = 4, 16, 12, 2
TOL = 1e-5
EXPERTS = (6, 5)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max() + 1e-30))


def _embed_cases():
    rng = np.random.default_rng(0)
    v, d = 1024, 64  # 2^16 entries: the spec rules also split the table over data (FSDP)
    ids = rng.integers(0, v, (B, S)).astype(np.int64)
    ids[0, :4] = ids[1, :4]  # repeated ids: their gradients accumulate
    return [{"shard_vocab_embed": vocab, "w": rng.standard_normal((v, d)).astype(np.float32),
             "ids": ids, "g": rng.standard_normal((B, S, d)).astype(np.float32)}
            for vocab in (False, True)]


def _moe_case(num_experts: int):
    """qwen2-moe-a2.7b's smoke config in f32 with ``num_experts`` dense
    experts: the port's config and a case of JAX's initial weights, a
    batch, a prompt and JAX's loss on them."""
    base = get_config("qwen2-moe-a2.7b", smoke=True)
    moe = dataclasses.replace(base.moe, num_experts=num_experts, impl="dense")
    cfg = base.replace(dtype="float32", moe=moe)
    jcfg = jax_config("qwen2-moe-a2.7b", smoke=True).replace(dtype="float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, num_experts=num_experts, impl="dense"))
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(num_experts))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(num_experts)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jloss, _ = jm.loss_fn(jcfg, jparams, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    return cfg, {"arch": "qwen2-moe-a2.7b", "cfg": {"dtype": "float32", "moe": moe},
                 "params": tree_map(lambda t: t.numpy(), params), "batch": batch,
                 "prompt": prompt, "decode_steps": DECODE, "jax_loss": float(jloss)}


def _plain(cfg, case):
    fresh = lambda: tree_map(lambda a: torch.from_numpy(a.copy()), case["params"])  # noqa: E731
    opt = AdamW()
    p = fresh()
    state = {"params": p, "opt": opt.init(p), "step": torch.zeros((), dtype=torch.int32)}
    state, out = make_train_step(cfg, opt)(
        state, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
    res = {"loss": out["loss"].numpy(), "mu": tree_map(lambda t: t.numpy(), state["opt"]["mu"])}
    p = fresh()
    _, logits = make_prefill_step(cfg)(p, torch.from_numpy(case["prompt"]))
    res["prefill"] = logits.numpy()
    cache = tm.init_decode_cache(cfg, B, PROMPT, torch.device("cpu"))
    decode, res["decode"] = make_decode_step(cfg), []
    for i in range(DECODE):
        cache, logits = decode(p, cache, torch.from_numpy(case["prompt"][:, i:i + 1].copy()))
        res["decode"].append(logits.numpy())
    return res


_RUN = """
import sys
import repro_torch.configs as C
from repro_torch.launch import dryrun
C.SHAPES["_train"] = dict(seq_len=128, global_batch=256, kind="train")

def one_layer(arch):
    cfg = C.get_config(arch)
    (kinds, _), = cfg.stages
    return cfg.replace(stages=((kinds, 1),))

dryrun.get_config = one_layer
for arch in ("qwen2-moe-a2.7b", "dbrx-132b"):
    try:
        dryrun.main(["--arch", arch, "--shape", "_train", "--mesh", "single", "--out", sys.argv[1]])
    except SystemExit as e:
        if e.code:
            print("failed", arch, file=sys.stderr)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo ranks' outputs (two embedding cases, then a MoE case per
    ``EXPERTS``) and the dry run's records, from one spawn and one
    process that run side by side."""
    tmp = tmp_path_factory.mktemp("moe_spmd")
    dry = subprocess.Popen([sys.executable, "-c", _RUN, str(tmp / "dryrun.json")],
                           env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        moe = [_moe_case(e) for e in EXPERTS]
        embed = _embed_cases()
        got = run_ranks(4, str(tmp / "init"), embed + [c for _, c in moe], timeout_s=240.0,
                        target=_spmd_step_rank)[0]
        _, err = dry.communicate(timeout=300)
    finally:
        dry.kill()
    return {"embed": list(zip(embed, got[:2])),
            "moe": {e: (cfg, case, g) for e, (cfg, case), g in zip(EXPERTS, moe, got[2:])},
            "dry_rc": dry.returncode, "dry_err": err,
            "dry": json.loads((tmp / "dryrun.json").read_text()) if dry.returncode == 0 else {}}


# ------------------------------------------------------------- embedding

@pytest.mark.parametrize("vocab", [False, True], ids=["d_over_data", "vocab_over_model"])
def test_embedding_per_shard_is_bit_equal_to_plain(runs, vocab):
    case, got = runs["embed"][int(vocab)]
    assert case["shard_vocab_embed"] == vocab
    assert got["spec"] == (("model", "data") if vocab else (None, "data"))
    w = torch.from_numpy(case["w"].copy()).requires_grad_()
    rows = w[torch.from_numpy(case["ids"])]
    (rows * torch.from_numpy(case["g"])).sum().backward()
    np.testing.assert_array_equal(got["rows"], rows.detach().numpy())
    np.testing.assert_array_equal(got["grad"], w.grad.numpy())


# ------------------------------------------------------------- dense MoE

@pytest.mark.parametrize("experts", EXPERTS, ids=["experts_over_model", "ff_over_model"])
def test_sharded_dense_moe_matches_unsharded(runs, experts):
    cfg, case, got = runs["moe"][experts]
    plain = _plain(cfg, case)
    _close(got["loss"], plain["loss"])
    _close(got["loss"], case["jax_loss"])
    mu_got, mu_want = tree_leaves(got["mu"]), tree_leaves(plain["mu"])
    assert len(mu_got) == len(mu_want)
    for g, w in zip(mu_got, mu_want):
        _close(g, w)
    _close(got["prefill"], plain["prefill"])
    assert len(got["decode"]) == DECODE
    for g, w in zip(got["decode"], plain["decode"]):
        _close(g, w)


# ------------------------------------------------------------- dry run

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
def test_full_width_moe_train_dry_run_is_ok(runs, arch):
    assert runs["dry_rc"] == 0, runs["dry_err"][-3000:]
    r = runs["dry"][f"{arch}|_train|single|fsdp_tp|baseline"]
    assert r["status"] == "ok", r.get("error")
    assert r["kind"] == "train" and r["chips"] == 256
    assert r["flops_per_device"] > 0 and r["collective_per_device_bytes"] > 0
