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
from torch.utils._python_dispatch import TorchDispatchMode

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
from repro_torch.configs import get_config
from repro_torch.configs.granite_3_8b import smoke_config as torch_granite
from repro_torch.configs.recurrentgemma_2b import smoke_config as torch_smoke
from repro_torch.core.readpath import ReadPathConfig, build_data_plane
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
from repro_torch.utils.tree import (
    flatten_with_path,
    path_str,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

VOCAB, SEQ, RECORDS, BATCH = 128, 32, 32, 4
# the matrix products: every ``@`` and ``einsum`` of a period, batched ones
# included, as ``checkpoint_dots`` keeps every ``dot_general``
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default))


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


def test_dots_remat_matches_jax_checkpoint_dots(pair):
    """``remat="dots"`` (the checkpointed segments between products) against JAX's
    ``jax.grad`` under ``checkpoint_dots``: the loss to 1e-5, each gradient
    leaf to 1e-4 of its largest entry."""
    jcfg, jparams, tcfg, tparams = pair
    jcfg, tcfg = jcfg.replace(remat="dots"), tcfg.replace(remat="dots")
    toks, labels = _batch(32, 11)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}),
        has_aux=True))(jparams)
    tl, _, tg = _torch_loss_and_grads(tcfg, tparams, toks, labels)
    _rel_close(tl, jl, 1e-5)
    for g, want in zip(tg, jax.tree_util.tree_leaves(jg)):
        _rel_close(g, want, 1e-4)


class _DotCounter(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    def __init__(self, ops=_DOT_OPS):
        super().__init__()
        self.n, self.ops = 0, ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.ops:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def dot_counts(pair):
    """{remat: (matrix products in the forward, in the backward)}."""
    _, _, tcfg, tparams = pair
    toks, labels = _batch(32, 12)
    out = {}
    for remat in ("none", "dots", "full"):
        leaves = [p.clone().requires_grad_() for p in tree_leaves(tparams)]
        fwd, bwd = _DotCounter(), _DotCounter()
        with fwd:
            loss, _ = tm.loss_fn(tcfg.replace(remat=remat), tree_unflatten(tparams, leaves),
                                 {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
        with bwd:
            torch.autograd.grad(loss, leaves)
        out[remat] = (fwd.n, bwd.n)
    return out


def test_dots_backward_recomputes_no_matrix_product(pair, dot_counts):
    """Under ``"dots"`` the backward runs only the gradients' products, as
    without remat; under ``"full"`` it also recomputes the pattern
    periods' products: all of the forward's but the logits' and, per
    period, the FFN's output product (checkpoint stops a recompute once
    the tensors the backward needs are back, and no backward needs that
    product's output)."""
    periods = sum(r for _, r in pair[2].stages)
    (fwd, none_bwd), dots, full = dot_counts["none"], dot_counts["dots"], dot_counts["full"]
    assert dots == (fwd, none_bwd) and full[0] == fwd
    assert full[1] - none_bwd == fwd - 1 - periods


def test_dots_backward_recomputes_no_matrix_product_on_xlstm():
    """The same count on smoke xlstm (f32), the sLSTM's per-step product
    (``baddbmm`` into its buffer) counted too: under ``"dots"`` the forward
    and the backward run as many products as without remat (the chunkwise
    mLSTM's segments and the sLSTM's reverse-time backward recompute
    none); ``"full"`` recomputes the periods' products, the sLSTM's 32 a
    layer among them."""
    cfg = get_config("xlstm-1.3b", smoke=True).replace(dtype="float32", vocab_size=VOCAB)
    params = tm.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    toks, labels = _batch(32, 13)
    ops = _DOT_OPS | {torch.ops.aten.baddbmm.out}
    counts = {}
    for remat in ("none", "dots", "full"):
        leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
        fwd, bwd = _DotCounter(ops), _DotCounter(ops)
        with fwd:
            loss, _ = tm.loss_fn(cfg.replace(remat=remat), tree_unflatten(params, leaves),
                                 {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
        with bwd:
            torch.autograd.grad(loss, leaves)
        counts[remat] = (fwd.n, bwd.n)
    assert counts["dots"] == counts["none"] and counts["full"][0] == counts["none"][0]
    assert counts["full"][1] - counts["none"][1] >= 2 * 32  # two sLSTM layers


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


def test_trainer_put_fn_and_recycle_fn(pair, corpus, jax_run):
    """``put_fn`` moves each fetched batch; ``recycle_fn`` gets that raw
    batch back after its step, once, in order; the losses are JAX's."""
    jt, init = jax_run
    store = RecordStore(corpus)
    put, recycled = [], []

    def put_fn(raw):
        put.append(raw)
        return {k: torch.from_numpy(v.copy()) for k, v in raw.items()}

    tt = Trainer(pair[2], lambda idx: decode_token_batch(store.read_batch(idx), SEQ),
                 make_shuffler("lirs", RECORDS, BATCH, seed=0),
                 TrainLoopConfig(epochs=1, seed=0), opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=2),
                 put_fn=put_fn, recycle_fn=recycled.append, device="cpu")
    _copy_params(tt.state["params"], init)
    tt.train()
    assert tt.global_step == len(put) == RECORDS // BATCH
    assert len(recycled) == len(put) and all(a is b for a, b in zip(recycled, put))
    for got, want in zip(tt.history, jt.history):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    store.close()


def test_trainer_batch_iter_fn_through_the_tier(pair, corpus, jax_run):
    """``batch_iter_fn`` replaces the shuffler's batches: the tiered
    plane's ``batch_iter`` feeds the pipeline and its fetcher the bytes;
    the losses are the JAX direct run's."""
    jt, init = jax_run
    store = RecordStore(corpus)
    sh = make_shuffler("lirs", RECORDS, BATCH, seed=0)
    plane = build_data_plane(store, ReadPathConfig(shuffler=sh, cache_budget_bytes=16 * 132,
                                                   max_epochs=1, eviction_policy="belady"))
    epochs = []

    def batch_iter(epoch):
        epochs.append(epoch)
        return plane.batch_iter(epoch)

    tt = Trainer(pair[2], lambda idx: decode_token_batch(plane(idx), SEQ), sh,
                 TrainLoopConfig(epochs=1, max_steps=4, seed=0),
                 opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=2), batch_iter_fn=batch_iter,
                 device="cpu")
    _copy_params(tt.state["params"], init)
    tt.train()
    plane.close()
    assert epochs == [0] and plane.cache.hits + plane.cache.misses >= 4 * BATCH
    for got, want in zip(tt.history, jt.history):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    store.close()


def test_trainer_epoch_hook_fires_after_each_completed_epoch(pair, corpus):
    """``epoch_hook(epoch)`` runs once an epoch's last step is done, and
    not for an epoch that ``max_steps`` cut short."""
    store, fired = RecordStore(corpus), []
    tt = Trainer(pair[2], lambda idx: decode_token_batch(store.read_batch(idx), SEQ),
                 make_shuffler("lirs", RECORDS, BATCH, seed=0),
                 TrainLoopConfig(epochs=2, max_steps=12, seed=0),
                 opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=2),
                 epoch_hook=lambda epoch: fired.append((epoch, tt.global_step)), device="cpu")
    tt.train()
    assert tt.global_step == 12 and fired == [(0, RECORDS // BATCH)]
    store.close()


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


def test_trainer_log_path_writes_the_jax_trainers_records(pair, corpus, jax_run, tmp_path):
    """``log_path``: one JSON record a step, appended, with the keys of the
    JAX ``Trainer``'s records; the file is closed at the end."""
    jt, init = jax_run
    log = tmp_path / "metrics.jsonl"
    log.write_text('{"earlier": 1}\n')
    tt = _torch_trainer(corpus, pair[2], steps=3, log_path=str(log))
    _copy_params(tt.state["params"], init)
    tt.train()
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert lines[0] == {"earlier": 1} and lines[1:] == tt.history
    assert [r["step"] for r in lines[1:]] == [1, 2, 3]
    assert all(set(r) == set(jt.history[0]) for r in lines[1:])
    assert tt._log_f is None


@pytest.mark.parametrize("keep", [1, 3])
def test_trainer_keeps_keep_ckpts_checkpoints(pair, corpus, tmp_path, keep):
    tt = _torch_trainer(corpus, pair[2], steps=4, ckpt_every=1, ckpt_dir=str(tmp_path),
                        keep_ckpts=keep)
    assert tt.ckpt.keep == keep
    tt.train()
    assert sorted(tt.ckpt._valid_checkpoints()) == list(range(5 - keep, 5))


def test_save_async_snapshots_then_restores_as_save(tmp_path):
    """``save_async`` copies the state on the caller's thread: updating it
    in place right after does not reach the file; after ``wait`` the
    checkpoint restores to the leaves that ``save`` writes."""
    state = {"w": torch.randn(64, 32), "m": {"b": torch.randn(5).bfloat16()},
             "step": torch.tensor(3, dtype=torch.int32)}
    snap = tree_map(torch.clone, state)
    a, b = CheckpointManager(str(tmp_path / "a")), CheckpointManager(str(tmp_path / "b"))
    a.save_async(3, state, extra={"epoch": 1})
    for leaf in tree_leaves(state):
        leaf.add_(1)
    b.save(3, snap, extra={"epoch": 1})
    a.wait()
    assert a._pending is None and a.latest_step() == 3
    got_a, extra_a, _ = a.restore(snap)
    got_b, extra_b, _ = b.restore(snap)
    assert extra_a == extra_b == {"epoch": 1}
    for x, y, want in zip(tree_leaves(got_a), tree_leaves(got_b), tree_leaves(snap)):
        assert torch.equal(x, want) and torch.equal(y, want)


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


# the multi-host tier at smoke size: 16 token records of 17 int32 (68
# bytes), a fleet budget of half of them, 2 epochs of 4 global batches of 4
MH_ARGS = ["--arch", "recurrentgemma-2b", "--smoke", "--num-records", "16", "--seq-len", "16",
           "--batch", "4", "--epochs", "2", "--lr", "3e-3", "--prefetch-lookahead", "2",
           "--cache-mb", str(8 * 68 / 2**20), "--eviction-policy", "belady"]
DISTRIBUTED_MODEL_KEYS = ("hosts", "policy", "fleet_capacity_records",
                          "expected_steady_storage_records_per_epoch")


@pytest.fixture(scope="module")
def one_host_summary():
    return launch.main(MH_ARGS + ["--hosts", "1", "--device", "cpu"])


@pytest.mark.parametrize("hosts", [2, 4])
def test_launcher_hosts_match_one_host_and_jax(one_host_summary, hosts):
    """``--hosts N --cache-mb``: the cluster serves every batch as one host
    does, so the losses are equal; the ``distributed`` block's placement
    numbers and the drift report's context and checks are the JAX
    launcher's at the same flags, and the storage reads sit at the floor."""
    from repro.launch import train as jax_launch

    got = launch.main(MH_ARGS + ["--hosts", str(hosts), "--device", "cpu"])
    want = jax_launch.main(MH_ARGS + ["--hosts", str(hosts)])
    assert got["losses"] == one_host_summary["losses"] and len(got["losses"]) == 8
    assert "cache" not in got and "cache" in one_host_summary
    dist, jdist = got["distributed"], want["distributed"]
    assert list(dist) == list(jdist)
    for key in DISTRIBUTED_MODEL_KEYS:
        assert dist[key] == jdist[key]
    assert dist["hosts"] == hosts and dist["fleet_capacity_records"] == 8
    assert dist["storage_records"] == 16 + dist["expected_steady_storage_records_per_epoch"]
    assert dist["remote_hits"] > 0
    assert dist["peer_failures"] == dist["push_errors"] == 0
    assert got["drift"]["context"] == want["drift"]["context"]
    assert set(got["drift"]["checks"]) == set(want["drift"]["checks"])
    assert got["drift"]["checks"]["split/storage"]["ok"]


@pytest.mark.parametrize("flags", [["--hosts", "2"], ["--hosts", "4", "--drift-device", "ssd"],
                                   ["--hosts", "0", "--cache-mb", "1"]])
def test_launcher_hosts_need_the_tier(flags):
    """``--hosts > 1`` without ``--cache-mb`` raises (the JAX launcher
    quietly runs one host), as does ``--hosts`` below 1."""
    with pytest.raises(ValueError, match="--hosts"):
        launch.main(ARGS + flags)


# the tiered read path at smoke size: 16 token records of 17 int32 (68
# bytes), half of them cached, 2 epochs of 8 steps
TIER_ARGS = ["--arch", "recurrentgemma-2b", "--smoke", "--num-records", "16", "--seq-len", "16",
             "--batch", "2", "--epochs", "2", "--lr", "3e-3", "--prefetch-lookahead", "4"]
TIER_FLAGS = ["--cache-mb", str(8 * 68 / 2**20), "--eviction-policy", "belady"]


@pytest.fixture(scope="module")
def jax_tier_summary():
    from repro.launch import train as jax_launch

    return jax_launch.main(TIER_ARGS + TIER_FLAGS + ["--drift-device", "optane"])


@pytest.fixture(scope="module")
def direct_summary():
    return launch.main(TIER_ARGS + ["--device", "cpu"])


@pytest.mark.parametrize("flags", [[], ["--drift-device", "optane"]])
def test_launcher_tier_matches_jax(jax_tier_summary, direct_summary, flags):
    """``--cache-mb > 0``: the tier leaves every batch, so every loss, as
    the direct path has it; the summary carries the JAX launcher's
    ``cache`` block, field for field, and a ``drift`` report that holds
    against the closed forms, as the JAX launcher's does."""
    got = launch.main(TIER_ARGS + TIER_FLAGS + flags + ["--device", "cpu"])
    want = jax_tier_summary
    assert JAX_SUMMARY_KEYS | {"cache", "drift"} <= set(got)
    assert got["steps"] == want["steps"] == 16
    np.testing.assert_allclose(got["losses"], direct_summary["losses"], rtol=1e-5)
    assert list(got["cache"]) == list(want["cache"])
    for key in ("policy", "planner", "budget_bytes"):
        assert got["cache"][key] == want["cache"][key]
    assert got["cache"]["demand_hits"] + got["cache"]["demand_misses"] == 2 * 16
    assert got["cache"]["rejected_inserts"] == got["cache"]["plans_failed"] == 0
    assert want["drift"]["ok"] and got["drift"]["ok"], got["drift"]
    assert got["drift"]["context"] == want["drift"]["context"]
    checks = set(want["drift"]["checks"])
    assert set(got["drift"]["checks"]) == (checks if flags else checks - {"t_epoch_read_s"})
    assert "cache" not in direct_summary and "drift" not in direct_summary


def test_launcher_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main(ARGS[:-2])  # --device defaults to cuda
