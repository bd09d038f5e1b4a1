"""The port's LM training path against the JAX package, on the CPU.

Smoke recurrentgemma in float32 with the JAX parameters carried across by
``params_from_jax``.  Tolerances (float32 sums taken in another order by
the two frameworks):
  * ``loss_fn``: the loss to 1e-5 relative; each gradient leaf to 1e-4
    relative to its largest entry (measured ~1e-5);
  * one AdamW update from identical gradients: 1e-6 (f32 and bf16-master);
    one microbatched train step: its gradients (read from the first
    moments) to 1e-4 of each leaf's largest entry, its weights to what
    Adam's first step, lr·m̂/(sqrt(v̂) + eps), makes of the two gradients
    + 1e-6 + 1e-5·|p|;
  * the 4-step ``Trainer`` over one record file and LIRS shuffler: each
    step's loss to 1e-5 relative, its global gradient norm to 1e-4;
  * checkpoints: leaves equal; preempt + resume: the final loss to 1e-4
    relative, as ``tests/test_system.py`` holds the JAX loop.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.granite_3_8b import smoke_config as jax_granite
from repro.configs.recurrentgemma_2b import smoke_config as jax_smoke
from repro.data.synthetic import decode_token_batch as jax_decode
from repro.data.synthetic import make_token_dataset
from repro.models import model as jm
from repro.storage.record_store import RecordStore as JaxStore
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JaxCheckpoints
from repro.train.loop import Trainer as JaxTrainer
from repro.train.loop import TrainLoopConfig as JaxLoopConfig
from repro.train.loop import make_shuffler as jax_shuffler
from repro.train.steps import make_train_step as jax_train_step
from repro_torch.configs.granite_3_8b import smoke_config as torch_granite
from repro_torch.configs.recurrentgemma_2b import smoke_config as torch_smoke
from repro_torch.data.synthetic import decode_token_batch
from repro_torch.kernels import ref
from repro_torch.launch import train as launch
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax
from repro_torch.storage.record_store import RecordStore
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import PreemptionError, Trainer, TrainLoopConfig, make_shuffler
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.utils.tree import flatten_with_path, path_str, tree_leaves, tree_unflatten

VOCAB, SEQ, RECORDS, BATCH = 128, 32, 32, 4


def _jax_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max() + 1e-30))


def _copy_params(dst, jax_params):
    for d, s in zip(tree_leaves(dst), tree_leaves(params_from_jax(_jax_np(jax_params)))):
        d.copy_(s)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke().replace(dtype="float32", vocab_size=VOCAB)
    tcfg = torch_smoke().replace(dtype="float32", vocab_size=VOCAB)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_jax(_jax_np(jparams))


def _batch(s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (2, s)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (2, s)).astype(np.int32)
    labels[0, :3] = -1  # masked positions
    return toks, labels


def _torch_loss_and_grads(cfg, params, toks, labels):
    leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    loss, metrics = tm.loss_fn(cfg, tree_unflatten(params, leaves), batch)
    return loss, metrics, torch.autograd.grad(loss, leaves)


# -------------------------------------------------------------------- loss


@pytest.mark.parametrize("s,loss_impl,loss_chunk", [
    (12, "log_softmax", 0),   # s <= window: masked local attention
    (32, "lse", 0),           # s > window: chunked local attention
    (32, "log_softmax", 8),   # the sequence-chunked loss
])
def test_loss_fn_and_grads_match_jax(pair, s, loss_impl, loss_chunk):
    jcfg, jparams, tcfg, tparams = pair
    jcfg = jcfg.replace(loss_impl=loss_impl, loss_chunk=loss_chunk)
    tcfg = tcfg.replace(loss_impl=loss_impl, loss_chunk=loss_chunk)
    toks, labels = _batch(s, s)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}),
        has_aux=True))(jparams)
    tl, tmet, tg = _torch_loss_and_grads(tcfg, tparams, toks, labels)
    _rel_close(tl, jl, 1e-5)
    _rel_close(tmet["ce"], jmet["ce"], 1e-5)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    for (path, _), g, want in zip(flatten_with_path(tparams), tg, jax.tree_util.tree_leaves(jg)):
        assert g.shape == want.shape, path_str(path)
        _rel_close(g, want, 1e-4)


def test_attn_kind_trains_as_jax():
    """The ``attn`` kind in train mode (causal masked sdpa): smoke granite."""
    jcfg = jax_granite().replace(dtype="float32")
    tcfg = torch_granite().replace(dtype="float32")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(1))
    toks = np.random.default_rng(1).integers(0, 512, (2, 10)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jm.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tl, _, tg = _torch_loss_and_grads(tcfg, params_from_jax(_jax_np(jparams)), toks, labels)
    _rel_close(tl, jl, 1e-5)
    assert all(torch.isfinite(g).all() for g in tg)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_remat_modes_give_the_same_loss_and_grads(pair, remat):
    _, _, tcfg, tparams = pair
    toks, labels = _batch(32, 5)
    l0, _, g0 = _torch_loss_and_grads(tcfg, tparams, toks, labels)  # "dots"
    l1, _, g1 = _torch_loss_and_grads(tcfg.replace(remat=remat), tparams, toks, labels)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("remat,fwd_per_layer", [("dots", 2), ("none", 1)])
def test_step_runs_the_scan_per_rglru_layer(pair, monkeypatch, remat, fwd_per_layer):
    """The path's scan goes through ops.RGLRUScan: with remat, each RG-LRU
    layer runs the scan forward twice (forward, recompute) and its
    backward once a step — on the card, 36 and 18 launches for
    recurrentgemma-2b's 18 RG-LRU layers."""
    _, _, tcfg, _ = pair
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ref.rglru_scan, ref.rglru_scan_bwd

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(ref, "rglru_scan", count("fwd", fwd))
    monkeypatch.setattr(ref, "rglru_scan_bwd", count("bwd", bwd))
    cfg = tcfg.replace(remat=remat)
    opt = AdamW(AdamWConfig())
    state = init_train_state(cfg, torch.Generator().manual_seed(0), opt, "cpu")
    toks, labels = _batch(32, 6)
    make_train_step(cfg, opt)(state, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
    layers = sum(p.count("rglru") * r for p, r in cfg.stages)
    assert layers == 6
    assert calls == {"fwd": fwd_per_layer * layers, "bwd": layers}


# ---------------------------------------------------------------- optimizer


def test_params_from_jax_copies_bf16_leaves():
    """bf16 leaves were once viewed, not copied, from the JAX array's
    read-only buffer; the in-place AdamW update then wrote into it."""
    src = jnp.asarray([1.0, -2.0, 3.0], jnp.bfloat16)
    before = np.asarray(src).copy()
    t = params_from_jax({"w": np.asarray(src)})["w"]
    t.add_(1.0)
    np.testing.assert_array_equal(np.asarray(src).view(np.int16), before.view(np.int16))
    assert t.tolist() == [2.0, -1.0, 4.0]


@pytest.mark.parametrize("dtype,decay_steps", [("float32", 0), ("float32", 5), ("bfloat16", 0)])
def test_adamw_update_matches_jax(dtype, decay_steps):
    """Three updates from identical gradients (the first clipped): params,
    moments, master copy and metrics to 1e-6."""
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=decay_steps, weight_decay=0.1)
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 3)}}
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), params)
    jo = jopt.AdamW(jopt.AdamWConfig(**cfg))
    js = jo.init(jp)
    tp = params_from_jax(_jax_np(jp))
    to = AdamW(AdamWConfig(**cfg))
    ts = to.init(tp)
    assert ("master" in ts) == ("master" in js) == (dtype == "bfloat16")
    for i in range(3):
        scale = 10.0 if i == 0 else 0.1  # the first global norm is clipped
        grads = jax.tree_util.tree_map(lambda x: scale * rng.normal(size=x.shape).astype(np.float32), params)
        jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), grads)
        jp, js, jmet = jo.update(jg, js, jp)
        tmet = to.update(params_from_jax(_jax_np(jg)), ts, tp)
        for k in ("grad_norm", "lr"):
            _rel_close(tmet[k], jmet[k], 1e-6)
        assert int(ts["count"]) == int(js["count"]) == i + 1
        for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-6)
        for key in ("mu", "nu") + (("master",) if dtype == "bfloat16" else ()):
            for got, want in zip(tree_leaves(ts[key]), jax.tree_util.tree_leaves(js[key])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_microbatched_step_matches_jax(pair):
    """microbatches=2 (f32 gradient sum, then the mean) against the JAX
    step."""
    jcfg, jparams, tcfg, _ = pair
    toks, labels = _batch(16, 8)
    opt_cfg = dict(lr=3e-3, warmup_steps=2)
    jo = jopt.AdamW(jopt.AdamWConfig(**opt_cfg))
    jstate = {"params": jparams, "opt": jo.init(jparams), "step": jnp.zeros((), jnp.int32)}
    jstate, jout = jax.jit(jax_train_step(jcfg, jo, microbatches=2))(
        jstate, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    to = AdamW(AdamWConfig(**opt_cfg))
    state = init_train_state(tcfg, torch.Generator().manual_seed(0), to, "cpu")
    _copy_params(state["params"], jparams)
    state, out = make_train_step(tcfg, to, microbatches=2)(
        state, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert set(out) == set(jout) == {"loss", "grad_norm", "lr"}
    _rel_close(out["loss"], jout["loss"], 1e-5)
    _rel_close(out["grad_norm"], jout["grad_norm"], 1e-4)
    assert int(state["step"]) == int(jstate["step"]) == 1
    _assert_adam_step_close(state, jstate, float(jout["lr"]), AdamWConfig(**opt_cfg))


def _assert_adam_step_close(state, jstate, lr, c):
    """After one step: the clipped gradients, read from the first moments
    (mu = (1 - b1)·g), to 1e-4 of each leaf's largest entry; each weight to
    what Adam's first step, lr·m̂/(sqrt(v̂) + eps), makes of the two
    gradients (near g = 0 it magnifies their last digits) + 1e-6 +
    1e-5·|p|."""
    want = [[np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
            for t in (jstate["params"], jstate["opt"]["mu"], jstate["opt"]["nu"])]
    got = [[x.numpy() for x in tree_leaves(t)]
           for t in (state["params"], state["opt"]["mu"], state["opt"]["nu"])]
    for p, m, v, jp, jmu, jnu in zip(*got, *want):
        _rel_close(m, jmu, 1e-4)
        step = (m / (1 - c.b1)) / (np.sqrt(v / (1 - c.b2)) + c.eps)
        jstep = (jmu / (1 - c.b1)) / (np.sqrt(jnu / (1 - c.b2)) + c.eps)
        allowed = lr * np.abs(step - jstep) + 1e-6 + 1e-5 * np.abs(jp)
        assert (np.abs(p - jp) <= allowed).all()


def test_unported_step_options_raise(pair):
    _, _, tcfg, _ = pair
    opt = AdamW()
    with pytest.raises(NotImplementedError, match="compression"):
        make_train_step(tcfg, opt, compressor=object())
    state = init_train_state(tcfg, torch.Generator().manual_seed(0), opt, "cpu")
    toks, labels = _batch(16, 9)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tcfg, opt, microbatches=3)(
            state, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})


# ------------------------------------------------------------------ trainer


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokens")
    return make_token_dataset(str(d / "tok.rrec"), RECORDS, seq_len=SEQ, vocab=VOCAB, seed=2).path


def _torch_trainer(path, cfg, steps=4, **loop):
    store = RecordStore(path)
    return Trainer(
        cfg, lambda idx: decode_token_batch(store.read_batch(idx), SEQ),
        make_shuffler("lirs", RECORDS, BATCH, seed=0),
        TrainLoopConfig(epochs=loop.pop("epochs", 1), max_steps=steps, seed=0, **loop),
        opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=2), device="cpu",
    )


@pytest.fixture(scope="module")
def jax_run(pair, corpus):
    """JAX's Trainer, 4 steps over the corpus; its initial parameters."""
    jcfg = pair[0]
    store = JaxStore(corpus)
    jt = JaxTrainer(
        jcfg, lambda idx: jax_decode(store.read_batch(idx), SEQ),
        jax_shuffler("lirs", RECORDS, BATCH, seed=0),
        JaxLoopConfig(epochs=1, max_steps=4, seed=0),
        opt_cfg=jopt.AdamWConfig(lr=3e-3, warmup_steps=2),
    )
    init = _jax_np(jt.state["params"])
    jt.train()
    return jt, init


def test_trainer_losses_match_jax(pair, corpus, jax_run):
    jt, init = jax_run
    tt = _torch_trainer(corpus, pair[2])
    _copy_params(tt.state["params"], init)
    summary = tt.train()
    assert summary["steps"] == 4 and len(tt.history) == 4
    for got, want in zip(tt.history, jt.history):
        assert set(got) == set(want)
        assert got["step"] == want["step"] and got["epoch"] == want["epoch"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-7)
    assert summary["t_comp"] > 0 and summary["t_load"] > 0
    assert len(tt.step_seconds) == 4


def test_jax_checkpoint_restores_into_port(pair, corpus, jax_run, tmp_path):
    """A checkpoint the JAX package wrote (its trainer's state after 4
    steps) restores into the port's state, leaf for leaf."""
    jt, _ = jax_run
    JaxCheckpoints(str(tmp_path)).save(4, jt.state, extra={"epoch": 0, "step_in_epoch": 4})
    template = init_train_state(pair[2], torch.Generator().manual_seed(0), AdamW(), "cpu")
    state, extra, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 4 and extra == {"epoch": 0, "step_in_epoch": 4}
    want = dict(jax.tree_util.tree_flatten_with_path(jt.state)[0])
    got = flatten_with_path(state)
    assert len(got) == len(want)
    for (path, leaf), (jpath, jleaf) in zip(got, jax.tree_util.tree_flatten_with_path(jt.state)[0]):
        from repro.utils.tree import path_str as jax_path_str

        assert path_str(path) == jax_path_str(jpath)
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))


def test_checkpoint_roundtrip_bf16_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(10, dtype=torch.float32),
             "b": [{"c": torch.randn(3, 3).bfloat16()}, torch.tensor(7, dtype=torch.int32)]}
    for step in (5, 10, 15):
        cm.save(step, state, extra={"k": step})
    assert cm.latest_step() == 15 and len(cm._valid_checkpoints()) == 2
    with np.load(tmp_path / "step_0000000015" / "arrays.npz") as z:
        assert sorted(z.files) == ["a", "b/0/c", "b/1"]
        assert z["b/0/c"].dtype == np.uint16  # bf16 bits
    got, extra, step = cm.restore(state)
    assert step == 15 and extra == {"k": 15}
    assert got["b"][0]["c"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert torch.equal(a, b)
    # a torn newest checkpoint (no manifest) is ignored; a corrupt one skipped
    (tmp_path / "step_0000000020").mkdir()
    (tmp_path / "step_0000000020" / "arrays.npz").write_bytes(b"garbage")
    assert cm.latest_step() == 15
    manifest = tmp_path / "step_0000000015" / "manifest.json"
    m = json.loads(manifest.read_text())
    manifest.write_text(json.dumps(dict(m, digest="0" * 64)))
    _, _, step = cm.restore(state)
    assert step == 10
    with pytest.raises(ValueError, match="digest"):
        cm.restore(state, step=15)


def test_jax_bf16_checkpoint_restores_as_bits(tmp_path):
    w = jnp.asarray(np.random.default_rng(0).normal(size=(4, 3)), jnp.bfloat16)
    JaxCheckpoints(str(tmp_path)).save(1, {"w": w})
    got, _, _ = CheckpointManager(str(tmp_path)).restore({"w": torch.zeros(4, 3, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))


def test_preempt_and_resume_match_uninterrupted(pair, corpus, tmp_path):
    """Uninterrupted run == preempted + resumed run (same final loss); the
    resume replays from the last checkpoint (ckpt_every=4 → step 8)."""
    cfg = pair[2]
    base = _torch_trainer(corpus, cfg, steps=0, epochs=2)
    base.train()
    assert base.global_step == 16
    t1 = _torch_trainer(corpus, cfg, steps=0, epochs=2, fail_at_step=9,
                        ckpt_every=4, ckpt_dir=str(tmp_path))
    with pytest.raises(PreemptionError):
        t1.train()
    t2 = _torch_trainer(corpus, cfg, steps=0, epochs=2, ckpt_every=4, ckpt_dir=str(tmp_path))
    assert t2.try_resume() and t2.global_step == 9
    summary = t2.train()
    assert summary["steps"] == 16
    np.testing.assert_allclose(t2.history[-1]["loss"], base.history[-1]["loss"], rtol=1e-4)


# ----------------------------------------------------------------- launcher

ARGS = ["--arch", "recurrentgemma-2b", "--smoke", "--num-records", "32", "--seq-len", "16",
        "--batch", "4", "--lr", "3e-3", "--device", "cpu"]
JAX_SUMMARY_KEYS = {"steps", "final_loss", "t_load", "t_comp", "t_overlap", "t_unhidden_load",
                    "effective_time", "io_resilience"}


def test_launcher_smoke_cpu_runs_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    s1 = launch.main(ARGS + ["--epochs", "1", "--ckpt-dir", ck,
                             "--trace", str(tmp_path / "t.json"),
                             "--metrics-json", str(tmp_path / "m.json")])
    assert JAX_SUMMARY_KEYS <= set(s1)
    assert s1["steps"] == 8 and np.isfinite(s1["final_loss"])
    assert s1["device"] == "cpu" and s1["peak_memory_gib"] is None
    assert len(s1["step_seconds"]) == len(s1["losses"]) == 8
    assert s1["losses"][-1] == s1["final_loss"]
    assert s1["trace"]["events"] > 0 and (tmp_path / "m.json").exists()
    s2 = launch.main(ARGS + ["--epochs", "2", "--ckpt-dir", ck, "--resume",
                             "--chaos", "seed=1,transient=0.2"])
    assert s2["steps"] == 16 and np.isfinite(s2["final_loss"])
    assert s2["io_resilience"]["retries"] > 0


@pytest.mark.parametrize("flags", [["--cache-mb", "1"], ["--hosts", "2"], ["--drift-device", "ssd"]])
def test_launcher_refuses_the_unported_tier(flags):
    with pytest.raises(NotImplementedError, match="tiered read path"):
        launch.main(ARGS + flags)


def test_launcher_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main(ARGS[:-2])  # --device defaults to cuda
