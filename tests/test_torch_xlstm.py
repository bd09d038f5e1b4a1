"""The port's xLSTM kinds (``mlstm``, ``slstm``) against the JAX package,
on the CPU.

The JAX parameters are carried across by ``params_from_jax`` and the same
numpy inputs go into both packages.  Tolerances:
  * the layers in float32 (``mlstm_chunkwise`` with and without an
    initial state, ``mlstm_step``, ``slstm_scan``, ``slstm_step``):
    outputs and every state leaf to 1e-5 of the reference's largest
    entry (rtol = 1e-5, atol = 1e-5 * max|ref|: sums taken in another
    order; the mLSTM's outputs reach ~35 here);
  * the layers in bfloat16: a loose 5e-2 of the reference's largest
    entry; the two frameworks round bf16 at other points (JAX contracts
    its three-operand einsums in an order of its own);
  * ``mlstm_chunkwise`` against the port's ``mlstm_sequential_ref`` at
    2e-4, as ``tests/test_layers.py`` holds JAX's pair; at xlstm-1.3b's
    full width, where the reference is ill-conditioned, within twice the
    distance between JAX's own two forms;
  * gradients (the layers' and the smoke model's, against ``jax.grad``)
    to 1e-4 of each leaf's largest entry, the loss to 1e-5 relative, as
    ``tests/test_torch_train.py`` holds recurrentgemma's;
  * the smoke model's prefill logits, every cache leaf and 8 decode steps
    in float32 to 1e-4 (rtol = atol), as ``tests/test_torch_decode.py``;
    the logits in bfloat16 to 2e-1: at this config JAX's own bf16 run lies
    up to 4.8e-1 from its f32 run over these steps (the port's bf16 run up
    to 3.5e-1 from its f32 run, 1.4e-1 from JAX's bf16 run);
  * decode from ``init_decode_cache`` teacher-forced against prefill in
    f32 at 1e-4.  As in ``tests/test_models.py``, xlstm runs this check
    in f32 only: the chunkwise prefill and the recurrent decode are two
    algorithms for one recurrence and part by ~6e-2 in bf16;
  * the training launcher's smoke run in f32 against the JAX launcher's
    on the same weights, record file and shuffle: the final loss to 1e-5
    relative;
  * one period of xlstm-1.3b at full width (8 layers), f32, where the
    reference is ill-conditioned: bounds set over what rounding each of
    JAX's weights once more moves (loss 5e-4 relative, each layer's
    gradient norm 15%, logits 2e-2), and teacher-forced decode within
    three times JAX's own distance from its prefill, which exceeds 1e-3.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.layers import xlstm as jx
from repro.models import model as jm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.layers import xlstm as tx
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax
from repro_torch.utils.tree import flatten_with_path, tree_leaves, tree_unflatten

ARCH = "xlstm-1.3b"
D, HEADS = 64, 2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel_close(got, want, tol):
    """Within ``tol`` relative, and ``tol`` of the reference's largest entry."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max() + 1e-30))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


@pytest.fixture(scope="module")
def mlstm():
    jp = jx.init_mlstm(jax.random.PRNGKey(0), D, HEADS, 2.0, jnp.float32)
    return jp, _torch(jp)


@pytest.fixture(scope="module")
def slstm():
    jp = jx.init_slstm(jax.random.PRNGKey(1), D, HEADS, jnp.float32)
    return jp, _torch(jp)


# ------------------------------------------------------------------ init


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_shapes_and_dtypes_match_jax(kind):
    if kind == "mlstm":
        want = jx.init_mlstm(jax.random.PRNGKey(0), 2048, 4, 2.0, jnp.float32)
        got = tx.init_mlstm(torch.Generator().manual_seed(0), 2048, 4, 2.0, torch.float32, "cpu")
    else:
        want = jx.init_slstm(jax.random.PRNGKey(0), 2048, 4, jnp.float32)
        got = tx.init_slstm(torch.Generator().manual_seed(0), 2048, 4, torch.float32, "cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert got[key].dtype == torch.float32, key
    if kind == "mlstm":
        assert got["w_up"].shape == (2048, 4096) and got["wq"].shape == (4, 1024, 1024)
        assert got["b_if"].tolist() == [0.0] * 4 + [3.0] * 4
        assert torch.equal(got["skip"], torch.ones(4096))
        # dense_init's fan-in is shape[0], the head count, as in JAX: a
        # scale of 1/sqrt(4), not 1/sqrt(1024)
        assert 0.9 < float(got["wq"].abs().max()) <= 2.0 / 4 ** 0.5
    else:
        assert got["r"].shape == (4, 4, 512, 512) and not got["b"].any()
        assert float(got["r"].abs().max()) <= 2.0 / 512 ** 0.5


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_matches_jax(mlstm, dtype, with_state):
    """48 tokens in chunks of 16, then (``with_state``) 48 more from the
    state the first call left."""
    (jp, tp), (jdt, tdt), tol = mlstm, DTYPES[dtype], LAYER_TOL[dtype]
    x = _x((2, 48, D), 3)
    jstate = tstate = None
    if with_state:
        _, jstate = jx.mlstm_chunkwise(jp, jnp.asarray(_x((2, 48, D), 4), jdt), HEADS, 16, jdt)
        _, tstate = tx.mlstm_chunkwise(tp, torch.from_numpy(_x((2, 48, D), 4)).to(tdt),
                                       HEADS, 16, tdt)
    jy, jstate = jx.mlstm_chunkwise(jp, jnp.asarray(x, jdt), HEADS, 16, jdt, state=jstate)
    ty, tstate = tx.mlstm_chunkwise(tp, torch.from_numpy(x).to(tdt), HEADS, 16, tdt, state=tstate)
    assert ty.dtype == tdt and ty.shape == jy.shape
    _rel_close(ty, jy, tol)
    for got, want in zip(tstate, jstate):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _rel_close(got, want, LAYER_TOL["float32"] if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_step_matches_jax(mlstm, dtype):
    """Three decode steps from the state of a 16-token chunkwise pass."""
    (jp, tp), (jdt, tdt), tol = mlstm, DTYPES[dtype], LAYER_TOL[dtype]
    x = _x((2, 19, D), 5)
    _, jstate = jx.mlstm_chunkwise(jp, jnp.asarray(x[:, :16], jdt), HEADS, 16, jdt)
    _, tstate = tx.mlstm_chunkwise(tp, torch.from_numpy(x[:, :16]).to(tdt), HEADS, 16, tdt)
    for t in range(16, 19):
        jy, jstate = jx.mlstm_step(jp, jnp.asarray(x[:, t:t + 1], jdt), jstate, HEADS, jdt)
        ty, tstate = tx.mlstm_step(tp, torch.from_numpy(x[:, t:t + 1]).to(tdt), tstate, HEADS, tdt)
        _rel_close(ty, jy, tol)
    for got, want in zip(tstate, jstate):
        _rel_close(got, want, LAYER_TOL["float32"] if dtype == "float32" else 1e-3)


def test_mlstm_chunkwise_matches_sequential_ref():
    """``tests/test_layers.py::test_mlstm_chunkwise_matches_sequential`` on
    the port: d 32, 2 heads, 64 tokens in chunks of 16, f32, 2e-4."""
    params = tx.init_mlstm(torch.Generator().manual_seed(0), 32, 2, 2.0, torch.float32, "cpu")
    x = torch.from_numpy(_x((2, 64, 32), 12))
    y_chunk, chunk_state = tx.mlstm_chunkwise(params, x, 2, 16, torch.float32)
    y_seq, seq_state = tx.mlstm_sequential_ref(params, x, 2, torch.float32)
    _close(y_chunk, y_seq, 2e-4)
    for got, want in zip(chunk_state, seq_state):
        _rel_close(got, want, 2e-4)


def test_full_width_mlstm_is_as_close_to_jax_as_jax_is_to_itself():
    """One mLSTM layer at xlstm-1.3b's width (d 2048, 4 heads of 1,024)
    with JAX's initialisation, x ~ N(0, 1), 128 tokens in chunks of 64,
    f32.  There the reference is ill-conditioned: q·k sums 1,024 terms of
    q ~ 16 (``wq``'s fan-in is H, a scale of 0.5), the output reaches
    ~10^3, and JAX's own chunkwise and sequential forms part by ~4e-4 of
    its largest entry.  The port's chunkwise form is held to JAX's within
    twice that distance (at the smoke width they agree to 1e-5)."""
    jp = jx.init_mlstm(jax.random.PRNGKey(0), 2048, 4, 2.0, jnp.float32)
    x = np.random.default_rng(0).normal(size=(1, 128, 2048)).astype(np.float32)
    jy, _ = jx.mlstm_chunkwise(jp, jnp.asarray(x), 4, 64, jnp.float32)
    jr, _ = jx.mlstm_sequential_ref(jp, jnp.asarray(x), 4, jnp.float32)
    ty, _ = tx.mlstm_chunkwise(_torch(jp), torch.from_numpy(x), 4, 64, torch.float32)
    jy, jr = np.asarray(jy), np.asarray(jr)
    scale = float(np.abs(jy).max())
    own = float(np.abs(jy - jr).max()) / scale
    assert scale > 1e3 and own > 1e-5  # the conditioning this test is about
    assert float(np.abs(ty.numpy() - jy).max()) / scale <= 2 * own


@pytest.fixture(scope="module")
def full_width_period():
    """xlstm-1.3b at published width, one period of its pattern (7 mLSTM
    and 1 sLSTM layers, the depth cut 48 -> 8), f32, JAX's ``init_params``
    (key 0) carried across: the loss over 8 tokens and each layer's
    gradient norm, from ``jax.grad`` and from autograd, then each
    package's prefill logits over the 8 tokens and its 8 teacher-forced
    decode steps from ``init_decode_cache``.  ~8 GiB."""
    (pattern, _), = jax_config(ARCH).stages
    stages = ((pattern, 1),)
    jcfg = jax_config(ARCH).replace(dtype="float32", stages=stages)
    tcfg = get_config(ARCH).replace(dtype="float32", stages=stages)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = _torch(jparams)
    toks = _tokens(jcfg.vocab_size, (1, 9), 1)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}

    def norms(grads, leaves, host):
        return np.array([np.sqrt(sum(float((host(v).astype(np.float64) ** 2).sum())
                                     for v in leaves(grads["stages"][0][pi])))
                         for pi in range(len(pattern))])

    out = {}
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(jcfg, p, b)[0]))(jparams, jbatch)
    out["jax"] = [float(jl), norms(jg, jax.tree_util.tree_leaves, np.asarray)]
    del jg
    leaves = [p.requires_grad_() for p in tree_leaves(tparams)]
    tl, _ = tm.loss_fn(tcfg, tree_unflatten(tparams, leaves), tbatch)
    tg = tree_unflatten(tparams, list(torch.autograd.grad(tl, leaves)))
    out["port"] = [float(tl.detach()), norms(tg, tree_leaves, lambda v: v.numpy())]
    del tg
    for p in leaves:
        p.requires_grad_(False)
    _, pre = jax.jit(functools.partial(jm.prefill, jcfg))(jparams, jbatch["tokens"])
    step = jax.jit(functools.partial(jm.decode_step, jcfg))
    cache = jm.init_decode_cache(jcfg, 1, 8)
    for t in range(8):
        cache, last = step(jparams, cache, jbatch["tokens"][:, t:t + 1])
    out["jax"] += [_np(pre), _np(last)]
    with torch.no_grad():
        _, pre = tm.prefill(tcfg, tparams, tbatch["tokens"])
        cache = tm.init_decode_cache(tcfg, 1, 8, "cpu")
        for t in range(8):
            cache, last = tm.decode_step(tcfg, tparams, cache, tbatch["tokens"][:, t:t + 1])
    out["port"] += [_np(pre), _np(last)]
    return out


def test_full_width_period_matches_jax_as_closely_as_a_rounding_of_its_weights(full_width_period):
    """At full width the reference is ill-conditioned: within one period
    JAX's gradient norm grows ~2e5 from the sLSTM down to the first mLSTM
    after 8 tokens, and the same JAX run on weights each rounded once
    more (times 1 + 2^-24 z) moves its loss by 1.2e-4 relative, a layer's
    gradient norm by up to 6.1% and the last logits by 5.2e-3
    (``tools/kernel_xlstm_depth.py``).  The port is held inside bounds
    with room over that: the loss to 5e-4 relative, every layer's
    gradient norm to 15%, the logits to 2e-2 (measured 5.9e-6-5.9e-5,
    2.5-4.2%, 9.0e-4-4.7e-3 with 3 and 8 threads), and its gradient grows
    as JAX's does."""
    (jl, jn, jpre, _), (tl, tn, tpre, _) = full_width_period["jax"], full_width_period["port"]
    assert abs(tl - jl) <= 5e-4 * abs(jl)
    np.testing.assert_allclose(tn, jn, rtol=0.15)
    assert jn[0] / jn[-1] > 1e5 and tn[0] / tn[-1] > 1e5
    _close(tpre, jpre, 2e-2)


def test_full_width_teacher_forced_decode_parts_from_prefill_in_jax_too(full_width_period):
    """``tests/test_models.py``'s teacher-forced check at full width and 8
    layers, 8 tokens, f32: JAX's own decode lies 1.5e-2 from its own
    prefill (over 1e-3; 2.8e-3 between JAX's chunk schedules 256 and 2
    alone), so no f32 bound of 1e-3 holds the reference at depth.  The
    port's decode lies 5.2e-3-6.5e-3 from its prefill: held to at most
    three times JAX's own distance."""
    (_, _, jpre, jlast), (_, _, tpre, tlast) = full_width_period["jax"], full_width_period["port"]
    own = float(np.abs(jlast - jpre).max())
    assert own > 1e-3
    assert float(np.abs(tlast - tpre).max()) <= 3 * own


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slstm_scan_and_step_match_jax(slstm, dtype):
    """A 40-token scan, then three single steps from its state."""
    (jp, tp), (jdt, tdt), tol = slstm, DTYPES[dtype], LAYER_TOL[dtype]
    x = _x((2, 43, D), 6, scale=1.0)
    jy, jstate = jx.slstm_scan(jp, jnp.asarray(x[:, :40], jdt), HEADS, jdt)
    ty, tstate = tx.slstm_scan(tp, torch.from_numpy(x[:, :40]).to(tdt), HEADS, tdt)
    assert ty.dtype == tdt
    _rel_close(ty, jy, tol)
    for got, want in zip(tstate, jstate):  # the recurrence is f32 in every dtype
        assert got.dtype == torch.float32 and got.shape == want.shape
        _rel_close(got, want, LAYER_TOL["float32"] if dtype == "float32" else 1e-3)
    for t in range(40, 43):
        jy, jstate = jx.slstm_step(jp, jnp.asarray(x[:, t:t + 1], jdt), jstate, HEADS, jdt)
        ty, tstate = tx.slstm_step(tp, torch.from_numpy(x[:, t:t + 1]).to(tdt), tstate, HEADS, tdt)
        _rel_close(ty, jy, tol)
    for got, want in zip(tstate, jstate):
        _rel_close(got, want, LAYER_TOL["float32"] if dtype == "float32" else 1e-3)


def _grads_close(tgrads, jgrads):
    for name, got in tgrads.items():
        _rel_close(got, jgrads[name], 1e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_gradients_match_jax(mlstm, slstm, kind):
    """f32 gradients of a squared-output loss with respect to the
    parameters, the input and a nonzero initial state (the sLSTM's
    reverse-time backward through every state leaf; the mLSTM's chunk loop
    over 3 chunks) against ``jax.grad``."""
    jp, tp = mlstm if kind == "mlstm" else slstm
    x = _x((2, 48, D), 7, scale=1.0)
    if kind == "mlstm":
        _, state = jx.mlstm_chunkwise(jp, jnp.asarray(_x((2, 16, D), 8)), HEADS, 16, jnp.float32)

        def jfn(p, xx, st):
            return jx.mlstm_chunkwise(p, xx, HEADS, 16, jnp.float32, state=st)

        def tfn(p, xx, st):
            return tx.mlstm_chunkwise(p, xx, HEADS, 16, torch.float32, state=st)
    else:
        _, state = jx.slstm_scan(jp, jnp.asarray(_x((2, 8, D), 8)), HEADS, jnp.float32)

        def jfn(p, xx, st):
            return jx.slstm_scan(p, xx, HEADS, jnp.float32, state=st)

        def tfn(p, xx, st):
            return tx.slstm_scan(p, xx, HEADS, torch.float32, state=st)

    def jloss(p, xx, st):
        y, new = jfn(p, xx, st)
        return (y ** 2).mean() + sum((s_ ** 2).mean() for s_ in new[:2])

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x), state)
    tparams = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx_in = torch.from_numpy(x).requires_grad_()
    tstate = [torch.from_numpy(np.array(s_)).requires_grad_() for s_ in state]
    y, new = tfn(tparams, tx_in, tuple(tstate))
    loss = (y ** 2).mean() + sum((s_ ** 2).mean() for s_ in new[:2])
    loss.backward()
    _grads_close({k: v.grad for k, v in tparams.items()}, jg[0])
    _rel_close(tx_in.grad, jg[1], 1e-4)
    for got, want in zip(tstate, jg[2]):
        if float(np.abs(np.asarray(want)).max()) > 0:
            _rel_close(got.grad, want, 1e-4)


# ----------------------------------------------------------------- model


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def smoke(request):
    dtype = request.param
    jcfg = jax_config(ARCH, smoke=True).replace(dtype=dtype)
    tcfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(4))
    return dtype, jcfg, tcfg, jparams, _torch(jparams)


def test_full_config_matches_jax_field_by_field():
    assert ARCH in ARCH_IDS
    got, want = get_config(ARCH), jax_config(ARCH)
    names = [f.name for f in dataclasses.fields(got)]
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    extra = {f.name: f.default for f in dataclasses.fields(want) if f.name not in names}
    assert set(extra) == {"shard_vocab_embed", "sequence_parallel", "matmul_reduce_dtype"}
    assert all(getattr(want, n) == d for n, d in extra.items())
    assert (got.num_layers, got.d_model, got.num_heads, got.vocab_size) == (48, 2048, 4, 50304)
    assert got.stages == ((("mlstm",) * 7 + ("slstm",), 6),) and not got.tie_embeddings
    smoke_got, smoke_want = get_config(ARCH, smoke=True), jax_config(ARCH, smoke=True)
    assert all(getattr(smoke_got, n) == getattr(smoke_want, n) for n in names)


def test_param_count_at_full_size():
    assert tm.param_count(get_config(ARCH)) == jm.param_count(jax_config(ARCH)) == 2_047_318_352


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_smoke_model_loss_and_grads_match_jax(remat):
    """f32, 32 tokens (two chunks of 16), three labels masked; JAX under
    its own ``remat`` policy."""
    jcfg = jax_config(ARCH, smoke=True).replace(dtype="float32", remat=remat)
    tcfg = get_config(ARCH, smoke=True).replace(dtype="float32", remat=remat)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = _torch(jparams)
    toks = _tokens(jcfg.vocab_size, (2, 32), 9)
    labels = _tokens(jcfg.vocab_size, (2, 32), 10)
    labels[0, :3] = -1
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}),
        has_aux=True))(jparams)
    leaves = [p.clone().requires_grad_() for p in tree_leaves(tparams)]
    tl, _ = tm.loss_fn(tcfg, tree_unflatten(tparams, leaves),
                       {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    _rel_close(tl, jl, 1e-5)
    tg = torch.autograd.grad(tl, leaves)
    for (path, _), g, want in zip(flatten_with_path(tparams), tg, jax.tree_util.tree_leaves(jg)):
        assert g.shape == want.shape, path
        _rel_close(g, want, 1e-4)


def _cache_leaves(jcache, tcache):
    for si, stage in enumerate(jcache["stages"]):
        for pi, leaves in enumerate(stage):
            for key, want in leaves.items():
                yield f"stage {si} pos {pi} {key}", tcache["stages"][si][pi][key], want


@pytest.fixture(scope="module")
def smoke_run(smoke):
    """Prefill 32 tokens (two chunks), then 8 decode steps; both packages."""
    dtype, jcfg, tcfg, jparams, tparams = smoke
    toks = _tokens(tcfg.vocab_size, (2, 40), 11)
    jprefill = jax.jit(functools.partial(jm.prefill, jcfg))
    jdecode = jax.jit(functools.partial(jm.decode_step, jcfg))
    jcache, jl = jprefill(jparams, jnp.asarray(toks[:, :32]))
    tcache, tl = tm.prefill(tcfg, tparams, torch.from_numpy(toks[:, :32]))
    pre = (jcache, jl, {"pos": tcache["pos"], "stages": [
        tuple({k: v.clone() for k, v in leaves.items()} for leaves in stage)
        for stage in tcache["stages"]]}, tl)
    steps = []
    for t in range(32, 40):
        jcache, jl = jdecode(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tcache, tl = tm.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks[:, t:t + 1]))
        steps.append((jl, tl))
    return pre, steps, (jcache, tcache)


def test_prefill_logits_and_every_cache_leaf_match_jax(smoke, smoke_run):
    dtype = smoke[0]
    jcache, jl, tcache, tl = smoke_run[0]
    _close(tl, jl, 1e-4 if dtype == "float32" else 2e-1)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 32
    leaves = list(_cache_leaves(jcache, tcache))
    assert sorted({name.split()[-1] for name, _, _ in leaves}) == ["C", "c", "h", "m", "n"]
    for name, got, want in leaves:
        assert tuple(got.shape) == want.shape, name
        assert got.dtype == torch.float32 and str(want.dtype) == "float32", name
        if dtype == "float32":
            _close(got, want, 1e-4)


def test_decode_steps_match_jax(smoke, smoke_run):
    dtype = smoke[0]
    for i, (jl, tl) in enumerate(smoke_run[1]):
        assert tl.shape == jl.shape, i
        _close(tl, jl, 1e-4 if dtype == "float32" else 2e-1)
    jcache, tcache = smoke_run[2]
    assert int(tcache["pos"]) == int(jcache["pos"]) == 40
    if dtype == "float32":
        for name, got, want in _cache_leaves(jcache, tcache):
            _close(got, want, 1e-4)


def test_decode_from_an_empty_cache_matches_prefill():
    """``tests/test_models.py::test_decode_matches_prefill_logits`` on the
    port: 32 teacher-forced steps from ``init_decode_cache(cfg, 1, 32)``
    (the stabilisers ``m`` at -1e30) reproduce the last logits of the
    prefill, which runs the chunkwise mLSTM over two chunks of 16."""
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (1, 32), 3))
    _, want = tm.prefill(cfg, params, toks)
    cache = tm.init_decode_cache(cfg, 1, 32, "cpu")
    for t in range(32):
        cache, got = tm.decode_step(cfg, params, cache, toks[:, t:t + 1])
    _close(got, want, 1e-4)


def test_decode_updates_every_state_leaf_in_place():
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    cache = tm.init_decode_cache(cfg, 2, 16, "cpu")
    before = [(name, x.clone()) for name, x, _ in _cache_leaves(cache, cache)]
    new, _ = tm.decode_step(cfg, params, cache, torch.ones(2, 1, dtype=torch.int64))
    for (name, old), (_, a, _), (_, b, _) in zip(before, _cache_leaves(cache, cache),
                                                  _cache_leaves(new, new)):
        assert a is b, name
        assert not torch.equal(a, old), name
    assert int(new["pos"]) == 1


def test_prefill_refuses_a_length_the_chunk_does_not_divide():
    """JAX asserts ``S % min(chunk, S) == 0``; the port raises."""
    cfg = get_config(ARCH, smoke=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="mLSTM chunk 16"):
        tm.prefill(cfg, params, torch.ones(1, 24, dtype=torch.int64))


# -------------------------------------------------------------- launcher


def test_launcher_smoke_losses_match_the_jax_launcher(monkeypatch):
    """``python -m repro_torch.launch.train --arch xlstm-1.3b --smoke`` on
    the CPU against ``repro.launch.train`` with the same flags: both in
    f32 (each launcher's config patched to f32 compute), the port
    initialised with JAX's weights for the launcher's seed (the two PRNGs
    differ), the same record file and shuffle.  The final loss to 1e-5."""
    from repro.launch import train as jax_launch
    from repro_torch.launch import train as launch
    from repro_torch.train import steps as tsteps

    args = ["--arch", ARCH, "--smoke", "--num-records", "16", "--seq-len", "16", "--batch", "4",
            "--epochs", "1", "--lr", "3e-3"]
    monkeypatch.setattr(jax_launch, "get_config",
                        lambda a, smoke=False: jax_config(a, smoke).replace(dtype="float32"))
    monkeypatch.setattr(launch, "get_config",
                        lambda a, smoke=False: get_config(a, smoke).replace(dtype="float32"))
    want = jax_launch.main(args)

    def jax_weights(cfg, generator, device):
        jcfg = jax_config(ARCH, smoke=True).replace(dtype="float32", vocab_size=cfg.vocab_size)
        return params_from_jax(jax.tree_util.tree_map(
            np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0))), device)

    monkeypatch.setattr(tsteps.M, "init_params", jax_weights)
    got = launch.main(args + ["--device", "cpu"])
    assert got["steps"] == want["steps"] == 4
    assert np.all(np.isfinite(got["losses"]))
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-5)
