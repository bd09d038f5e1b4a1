"""The port's ``moe`` block kind and the four configs copied with it,
against the JAX package.

Inputs come from numpy seeds and the JAX parameters are carried across
by ``params_from_jax``; the smoke configs run in float32 compute, and
``apply_moe`` also in bf16, as both configs compute by default.
Tolerances:
  * ``apply_moe`` (dense and ragged dispatch): the routing ids equal
    exactly (a tie ordered otherwise by ``torch.topk`` shows here first),
    outputs and the aux loss to 1e-5 (rtol = atol); in bf16, outputs to
    one bf16 ulp at the output's largest magnitude;
  * gradients (``jax.grad``): each leaf to 1e-4 of its largest entry;
  * the smoke models' ``loss_fn`` to 1e-5, ``prefill``, three
    ``decode_step``s and ``extend_cache`` to 1e-4 (sums in another
    order);
  * ``param_count`` exactly, for every registered full config.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.layers import moe as jmoe
from repro.models import model as jm
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.layers import moe as tmoe
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import ServeEngine, synthetic_workload
from repro_torch.utils.tree import flatten_with_path, path_str, tree_leaves, tree_unflatten

NEW_ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b", "minitron-8b", "phi4-mini-3.8b")
MOE_ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")
F32 = jnp.float32


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _rel_close(got, want, tol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * float(np.abs(want).max() + 1e-30))


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _moe_cfg(arch, **moe_kw):
    """The JAX and port smoke configs of ``arch`` in float32, with
    ``moe_kw`` replacing fields of the MoE config."""
    jcfg = jax_config(arch, smoke=True).replace(dtype="float32")
    tcfg = get_config(arch, smoke=True).replace(dtype="float32")
    if moe_kw:
        jcfg = jcfg.replace(moe=jcfg.moe.__class__(**{**jcfg.moe.__dict__, **moe_kw}))
        tcfg = tcfg.replace(moe=tcfg.moe.__class__(**{**tcfg.moe.__dict__, **moe_kw}))
    return jcfg, tcfg


def _moe_inputs(jcfg, shape, seed):
    jparams = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jcfg.moe, F32)
    x = np.random.default_rng(seed).normal(size=shape + (jcfg.d_model,)).astype(np.float32)
    return jparams, _to_torch(jparams), x


# ------------------------------------------------------------ the layer


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_apply_moe_matches_jax(arch, impl):
    jcfg, tcfg = _moe_cfg(arch, impl=impl)
    jparams, tparams, x = _moe_inputs(jcfg, (2, 16), 1)
    _, jids, jaux = jmoe._router(jparams, jnp.asarray(x), jcfg.moe)
    _, tids, taux = tmoe._router(tparams, torch.from_numpy(x), tcfg.moe, False)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    jy, jm_ = jmoe.apply_moe(jparams, jnp.asarray(x), jcfg, jcfg.moe, F32)
    ty, ta = tmoe.apply_moe(tparams, torch.from_numpy(x), tcfg, tcfg.moe, torch.float32)
    _close(ty, jy, 1e-5)
    _close(ta, jm_["moe_aux"], 1e-5)
    _close(taux, jaux, 1e-5)


def _bf16_ulp(mag: float) -> float:
    """One bf16 ulp at magnitude ``mag`` (8 significant bits): the
    spacing of bf16 numbers in [2^e, 2^(e+1))."""
    return 2.0 ** (np.floor(np.log2(max(mag, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_apply_moe_matches_jax_in_bf16(arch, impl):
    """Both configs compute in bf16 by default.  With bf16 inputs and
    compute: the routing ids equal JAX's (the router runs in f32 on the
    same bf16 x), and ``apply_moe``'s output lies within one bf16 ulp of
    JAX's at the output's magnitude, ``2^(floor(log2 max|y|) - 7)`` (two
    f32 sums taken in another order, each rounded once to bf16)."""
    jcfg, tcfg = _moe_cfg(arch, impl=impl)
    jcfg, tcfg = jcfg.replace(dtype="bfloat16"), tcfg.replace(dtype="bfloat16")
    jparams, tparams, x = _moe_inputs(jcfg, (2, 64), 8)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    _, jids, _ = jmoe._router(jparams, jx, jcfg.moe)
    _, tids, _ = tmoe._router(tparams, tx, tcfg.moe, False)
    assert tids.numel() == 2 * 64 * tcfg.moe.experts_per_token
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    jy, _ = jmoe.apply_moe(jparams, jx, jcfg, jcfg.moe, jnp.bfloat16)
    ty, _ = tmoe.apply_moe(tparams, tx, tcfg, tcfg.moe, torch.bfloat16)
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    want = _np(jy)
    tol = _bf16_ulp(float(np.abs(want).max()))
    np.testing.assert_allclose(_np(ty), want, rtol=0, atol=tol)


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_dense_and_ragged_agree_without_drops(impl):
    """At a capacity that drops nothing, both dispatches compute one
    function (``tests/test_layers.py::test_moe_dense_vs_ragged_parity``)."""
    _, tcfg = _moe_cfg("qwen2-moe-a2.7b", capacity_factor=8.0)
    other = "ragged" if impl == "dense" else "dense"
    jcfg, _ = _moe_cfg("qwen2-moe-a2.7b")
    _, tparams, x = _moe_inputs(jcfg, (2, 16), 2)
    ys = [tmoe.apply_moe(tparams, torch.from_numpy(x), tcfg,
                         tcfg.moe.__class__(**{**tcfg.moe.__dict__, "impl": i}), torch.float32)
          for i in (impl, other)]
    _close(ys[0][0], ys[1][0], 2e-4)
    assert float(ys[0][1]) == float(ys[1][1])


def test_capacity_drops_tokens_as_jax():
    """``capacity_factor=0.25`` drops (token, choice) pairs: the port's
    dense output equals JAX's and differs from the loose capacity's."""
    jcfg, tcfg = _moe_cfg("qwen2-moe-a2.7b", capacity_factor=0.25)
    jloose, tloose = _moe_cfg("qwen2-moe-a2.7b", capacity_factor=8.0)
    jparams, tparams, x = _moe_inputs(jcfg, (2, 64), 3)
    assert tmoe._capacity(tcfg.moe, 64) == 8 < 2 * 64 // tcfg.moe.num_experts
    jy, _ = jmoe.apply_moe(jparams, jnp.asarray(x), jcfg, jcfg.moe, F32)
    ty, _ = tmoe.apply_moe(tparams, torch.from_numpy(x), tcfg, tcfg.moe, torch.float32)
    ly, _ = tmoe.apply_moe(tparams, torch.from_numpy(x), tloose, tloose.moe, torch.float32)
    _close(ty, jy, 1e-5)
    assert not np.allclose(_np(ty), _np(ly))


def test_group_size_regroups_as_jax():
    """``group_size`` 8 of a 32-token sequence: four groups, each with
    its own capacity (8, where the whole sequence would get 16)."""
    jcfg, tcfg = _moe_cfg("qwen2-moe-a2.7b", group_size=8)
    jparams, tparams, x = _moe_inputs(jcfg, (2, 32), 4)
    jy, jm_ = jmoe.apply_moe(jparams, jnp.asarray(x), jcfg, jcfg.moe, F32)
    ty, ta = tmoe.apply_moe(tparams, torch.from_numpy(x), tcfg, tcfg.moe, torch.float32)
    _close(ty, jy, 1e-5)
    _close(ta, jm_["moe_aux"], 1e-5)
    whole, _ = tmoe.apply_moe(tparams, torch.from_numpy(x), tcfg,
                              tcfg.moe.__class__(**{**tcfg.moe.__dict__, "group_size": 0}),
                              torch.float32)
    assert not np.allclose(_np(ty), _np(whole))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_moe_gradients_match_jax(arch, impl):
    jcfg, tcfg = _moe_cfg(arch, impl=impl)
    jparams, tparams, x = _moe_inputs(jcfg, (2, 16), 5)
    r = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, m = jmoe.apply_moe(p, xx, jcfg, jcfg.moe, F32)
        return jnp.sum(y * r) + m["moe_aux"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tparams)]
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.apply_moe(tree_unflatten(tparams, leaves), tx, tcfg, tcfg.moe, torch.float32)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux, leaves + [tx])
    for g, want in zip(grads, jax.tree_util.tree_leaves(jg) + [jgx]):
        assert g.shape == want.shape
        _rel_close(g, want, 1e-4)


def test_unknown_impl_is_refused():
    jcfg, tcfg = _moe_cfg("qwen2-moe-a2.7b", impl="sorted")
    _, tparams, x = _moe_inputs(jcfg, (1, 4), 7)
    with pytest.raises(ValueError, match="moe.impl"):
        tmoe.apply_moe(tparams, torch.from_numpy(x), tcfg, tcfg.moe, torch.float32)


# ------------------------------------------------------------ the model


def test_params_carry_leaf_for_leaf():
    """The port's parameter tree is JAX's, leaf for leaf: the same paths
    and shapes, so ``params_from_jax`` carries a MoE model unchanged."""
    for arch in MOE_ARCHS:
        jparams = jm.init_params(jax_config(arch, smoke=True), jax.random.PRNGKey(0))
        tparams = tm.init_params(get_config(arch, smoke=True), torch.Generator().manual_seed(0),
                                 "cpu")
        want = [(path_str(p), tuple(x.shape)) for p, x in
                flatten_with_path(jax.tree_util.tree_map(np.asarray, jparams))]
        got = [(path_str(p), tuple(x.shape)) for p, x in flatten_with_path(tparams)]
        assert got == want
        assert any("/moe/router" in "/" + p for p, _ in got)
        carried = _to_torch(jparams)
        assert all(torch.equal(a, torch.from_numpy(np.array(b))) for a, b in
                   zip(tree_leaves(carried), jax.tree_util.tree_leaves(jparams)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_jax(arch):
    assert tm.param_count(get_config(arch)) == jm.param_count(jax_config(arch))
    assert tm.param_count(get_config(arch), active_only=True) == \
        jm.param_count(jax_config(arch), active_only=True)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def smoke(request):
    arch = request.param
    jcfg = jax_config(arch, smoke=True).replace(dtype="float32")
    tcfg = get_config(arch, smoke=True).replace(dtype="float32")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(3))
    return arch, jcfg, tcfg, jparams, _to_torch(jparams)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


def test_smoke_loss_fn_matches_jax(smoke):
    arch, jcfg, tcfg, jparams, tparams = smoke
    toks = _tokens(tcfg.vocab_size, (2, 17), 8)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jmet = jax.jit(functools.partial(jm.loss_fn, jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet = tm.loss_fn(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, 1e-5)
    _close(tmet["ce"], jmet["ce"], 1e-5)
    _close(tmet["aux"], jmet["aux"], 1e-5)
    assert (float(tmet["aux"]) > 0) == (arch in MOE_ARCHS)


def test_smoke_prefill_decode_extend_match_jax(smoke):
    """``prefill`` of 12 tokens (logits and every K/V leaf), then
    ``extend_cache`` by 3 and three scalar-position ``decode_step``s."""
    _, jcfg, tcfg, jparams, tparams = smoke
    toks = _tokens(tcfg.vocab_size, (2, 15), 9)
    jcache, jlog = jax.jit(functools.partial(jm.prefill, jcfg))(jparams, jnp.asarray(toks[:, :12]))
    tcache, tlog = tm.prefill(tcfg, tparams, torch.from_numpy(toks[:, :12]))
    _close(tlog, jlog, 1e-4)
    for (path, got), want in zip(flatten_with_path(tcache["stages"]),
                                 jax.tree_util.tree_leaves(jcache["stages"])):
        assert got.shape == want.shape, path
        _close(got, want, 1e-4)
    jcache = jm.extend_cache(jcfg, jcache, 3)
    tcache = tm.extend_cache(tcfg, tcache, 3)
    assert [t.shape for t in tree_leaves(tcache["stages"])] == \
        [w.shape for w in jax.tree_util.tree_leaves(jcache["stages"])]
    jdecode = jax.jit(functools.partial(jm.decode_step, jcfg))
    for i in range(12, 15):
        jcache, jlog = jdecode(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        tcache, tlog = tm.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks[:, i:i + 1]))
        _close(tlog, jlog, 1e-4)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 15
    for got, want in zip(tree_leaves(tcache["stages"]), jax.tree_util.tree_leaves(jcache["stages"])):
        _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ragged_prefill_then_dense_decode_matches_prefill(arch):
    """The chip's MoE check at smoke size: ``impl="ragged"`` prefill
    (nothing dropped) against teacher-forced ``"dense"`` decode from an
    empty cache (a decode token is a group of one, capacity 8 >= k)."""
    _, tcfg = _moe_cfg(arch)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(4), "cpu")
    ragged = tcfg.replace(moe=tcfg.moe.__class__(**{**tcfg.moe.__dict__, "impl": "ragged"}))
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, (1, 16), 10))
    _, want = tm.prefill(ragged, params, toks)
    cache = tm.init_decode_cache(tcfg, 1, 16, "cpu")
    for i in range(16):
        cache, got = tm.decode_step(tcfg, params, cache, toks[:, i:i + 1])
    _close(got, want, 1e-4)


# ------------------------------------------------------------- training


class _DotCounter(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                     torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default))

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_moe_remat_modes_agree_and_dots_recomputes_no_product(impl):
    """On smoke qwen2-moe: ``"dots"``, ``"full"`` and ``"none"`` give the
    same loss and gradients bit for bit; ``"dots"``'s backward runs the
    products of the no-remat backward and no more, ``"full"``'s more."""
    _, tcfg = _moe_cfg("qwen2-moe-a2.7b", impl=impl)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(5), "cpu")
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, (2, 17), 11))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat in ("none", "dots", "full"):
        leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
        fwd, bwd = _DotCounter(), _DotCounter()
        with fwd:
            loss, met = tm.loss_fn(tcfg.replace(remat=remat), tree_unflatten(params, leaves), batch)
        with bwd:
            grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss, met["aux"], grads, fwd.n, bwd.n)
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert torch.equal(out[remat][1], out["none"][1])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][2], out["none"][2]))
    assert out["dots"][3:] == out["none"][3:]
    assert out["full"][4] > out["none"][4]


def test_moe_train_step_grads_match_jax():
    """The whole smoke qwen2-moe loss (cross-entropy + 0.01 · aux) under
    the default ``remat="dots"``: every gradient leaf against
    ``jax.grad`` under ``checkpoint_dots``."""
    jcfg = jax_config("qwen2-moe-a2.7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-moe-a2.7b", smoke=True).replace(dtype="float32")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(6))
    tparams = _to_torch(jparams)
    toks = _tokens(tcfg.vocab_size, (2, 17), 12)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(jparams)
    leaves = [p.clone().requires_grad_() for p in tree_leaves(tparams)]
    tl, _ = tm.loss_fn(tcfg, tree_unflatten(tparams, leaves),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, 1e-5)
    for g, want in zip(torch.autograd.grad(tl, leaves), jax.tree_util.tree_leaves(jg)):
        _rel_close(g, want, 1e-4)


# -------------------------------------------------------------- serving


def test_moe_engine_matches_jax_engine():
    """Smoke qwen2-moe through both serving engines (continuous mode, the
    JAX weights carried across, float32): every request completes with
    the same tokens, and no slot leaks."""
    jcfg = jax_config("qwen2-moe-a2.7b", smoke=True).replace(dtype="float32")
    tcfg = get_config("qwen2-moe-a2.7b", smoke=True).replace(dtype="float32")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(7))
    kw = dict(max_batch=3, prompt_capacity=8, max_new_tokens=6)
    reqs = synthetic_workload(10, vocab=tcfg.vocab_size, offered_load=0.8,
                              prompt_len=(2, 8), gen_len=(2, 6), seed=13)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, _to_torch(jparams), **kw)
    want = {c.rid: c.tokens for c in jeng.run(reqs)}
    got = {c.rid: c.tokens for c in teng.run(reqs)}
    assert got == want and len(got) == 10
    assert teng.free_slots == teng.max_batch and teng.active == 0
    assert (teng.decode_steps, teng.prefills) == (jeng.decode_steps, jeng.prefills)


def test_serve_launcher_takes_the_moe_arch():
    report = launch_serve.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device", "cpu",
                                "--max-batch", "2", "--prompt-capacity", "6", "--gen", "4",
                                "--requests", "4", "--offered-load", "1.0"])
    assert report["arch"] == "qwen2-moe-a2.7b-smoke"
    assert report["requests"] == 4 and report["slot_leaks"] == 0
