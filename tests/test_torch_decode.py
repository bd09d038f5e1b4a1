"""The port's scalar-position prefill and decode against the JAX package.

Smoke recurrentgemma (window 16: RG-LRU state caches and local-attention
rings) and smoke granite (``attn`` K/V caches), the JAX parameters
carried across by ``params_from_jax``, the same numpy tokens into both.
Tolerances:
  * float32: logits and every cache leaf to 1e-4 (rtol = atol; sums in
    another order, measured ~3e-6);
  * bfloat16: logits to 1e-1.  The two frameworks round bf16 at other
    points, and at this config JAX's own bf16 run is up to 8e-2 from its
    f32 run after 24 decode steps (the port's bf16 run is as far);
  * the JAX tests' own self-consistency checks, run on the port: decode
    from an empty cache against prefill at 2e-2
    (``tests/test_models.py::test_decode_matches_prefill_logits``) and
    prefill → ``extend_cache`` → decode against prefill at 3e-2
    (``tests/test_multihost.py::test_extend_cache_decode_matches_prefill``).
JAX's prefill and decode steps are jitted here, as the launcher jits
them, so the test spends its time on the comparisons.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.granite_3_8b import smoke_config as jax_granite
from repro.configs.recurrentgemma_2b import smoke_config as jax_rg
from repro.layers import attention as jattn
from repro.layers import rglru as jrglru
from repro.models import model as jm
from repro_torch.configs.granite_3_8b import smoke_config as torch_granite
from repro_torch.configs.recurrentgemma_2b import smoke_config as torch_rg
from repro_torch.layers import attention as tattn
from repro_torch.layers import rglru as trglru
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax
from repro_torch.train.steps import make_decode_step, make_prefill_step
from repro_torch.utils.tree import tree_map

TOL = {"float32": 1e-4, "bfloat16": 1e-1}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


def _models(jcfg, tcfg, seed=0):
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    prefill = jax.jit(functools.partial(jm.prefill, jcfg))
    decode = jax.jit(functools.partial(jm.decode_step, jcfg))
    return jparams, tparams, prefill, decode


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def rg(request):
    dtype = request.param
    jcfg, tcfg = jax_rg().replace(dtype=dtype), torch_rg().replace(dtype=dtype)
    return (dtype, jcfg, tcfg) + _models(jcfg, tcfg)


@pytest.fixture(scope="module")
def rg_run(rg):
    """Prefill 32 tokens (two windows: the chunked path and the ring's
    roll), then 24 decode steps, which wrap the 16-slot ring; both
    packages, every step's logits."""
    dtype, jcfg, tcfg, jparams, tparams, jprefill, jdecode = rg
    toks = _tokens(tcfg.vocab_size, (2, 56), 0)
    jcache, jl = jprefill(jparams, jnp.asarray(toks[:, :32]))
    tcache, tl = tm.prefill(tcfg, tparams, torch.from_numpy(toks[:, :32]))
    pre = (jcache, jl, tree_map(torch.clone, tcache), tl)  # decode writes in place
    steps = []
    for t in range(32, 56):
        jcache, jl = jdecode(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tcache, tl = tm.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks[:, t:t + 1]))
        steps.append((jl, tl))
    return pre, steps, (jcache, tcache)


def _cache_leaves(jcache, tcache):
    for si, stage in enumerate(jcache["stages"]):
        for pi, leaves in enumerate(stage):
            for key, want in leaves.items():
                yield f"stage {si} pos {pi} {key}", tcache["stages"][si][pi][key], want


def test_prefill_logits_and_every_cache_leaf(rg, rg_run):
    dtype, jcfg = rg[0], rg[1]
    jcache, jl, tcache, tl = rg_run[0]
    _close(tl, jl, TOL[dtype])
    assert int(tcache["pos"]) == int(jcache["pos"]) == 32
    assert tcache["pos"].dim() == 0
    leaves = list(_cache_leaves(jcache, tcache))
    assert sorted({name.split()[-1] for name, _, _ in leaves}) == ["conv", "h", "k", "v"]
    for name, got, want in leaves:
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        if name.endswith((" k", " v")):  # the ring: window 16 of the 32 positions
            assert got.shape[2] == jcfg.local_window
        if dtype == "float32":
            _close(got, want, TOL[dtype])


def test_decode_steps_wrap_the_ring(rg, rg_run):
    dtype = rg[0]
    for i, (jl, tl) in enumerate(rg_run[1]):
        assert tl.shape == jl.shape, i
        _close(tl, jl, TOL[dtype])
    jcache, tcache = rg_run[2]
    assert int(tcache["pos"]) == int(jcache["pos"]) == 56
    if dtype == "float32":
        for name, got, want in _cache_leaves(jcache, tcache):
            _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch", ["recurrentgemma", "granite"])
def test_decode_from_an_empty_cache_matches_prefill(arch):
    """JAX's ``test_decode_matches_prefill_logits`` on the port, bf16 as
    there: 8 teacher-forced steps from ``init_decode_cache(cfg, 1, 16)``
    reproduce prefill's last logits at 2e-2."""
    cfg = (torch_rg if arch == "recurrentgemma" else torch_granite)()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (1, 8), 3))
    _, want = tm.prefill(cfg, params, toks)
    cache = tm.init_decode_cache(cfg, 1, 16, "cpu")
    for t in range(8):
        cache, got = tm.decode_step(cfg, params, cache, toks[:, t:t + 1])
    _close(got, want, 2e-2)


def test_short_prompt_decodes_in_a_ring_of_its_length_as_jax():
    """After a prompt of 8 < window 16, JAX's ring has 8 slots, so decoding
    past the prompt wraps inside it (the window shrinks to 8): the port
    reproduces that, in f32 at 1e-4, and so differs from a prefill of the
    same 16 tokens, which sees them all."""
    jcfg, tcfg = jax_rg().replace(dtype="float32"), torch_rg().replace(dtype="float32")
    jparams, tparams, jprefill, jdecode = _models(jcfg, tcfg)
    toks = _tokens(tcfg.vocab_size, (1, 16), 4)
    jcache, _ = jprefill(jparams, jnp.asarray(toks[:, :8]))
    tcache, _ = tm.prefill(tcfg, tparams, torch.from_numpy(toks[:, :8]))
    assert tcache["stages"][0][2]["k"].shape[2] == 8
    for t in range(8, 16):
        jcache, jl = jdecode(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tcache, tl = tm.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, jl, 1e-4)
    _, full = tm.prefill(tcfg, tparams, torch.from_numpy(toks))
    assert float((tl - full).abs().max()) > 0.1


def test_apply_rglru_step_matches_jax():
    """One decode step from a nonzero state and conv history, f32."""
    rng = np.random.default_rng(5)
    jp = jrglru.init_rglru(jax.random.PRNGKey(2), 32, 48, 4, jnp.float32, num_heads=2)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    x = rng.normal(size=(3, 1, 32)).astype(np.float32)
    h0 = rng.normal(size=(3, 48)).astype(np.float32)
    hist = rng.normal(size=(3, 3, 48)).astype(np.float32)
    jy, (jh, jhist) = jrglru.apply_rglru_step(jp, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(hist)),
                                               jnp.float32)
    ty, (th, thist) = trglru.apply_rglru_step(tp, torch.from_numpy(x),
                                              (torch.from_numpy(h0), torch.from_numpy(hist)),
                                              torch.float32)
    assert ty.shape == (3, 1, 32) and th.dtype == torch.float32
    for got, want in ((ty, jy), (th, jh), (thist, jhist)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("t,window,curs", [
    (16, 16, [0, 5, 14]),        # cur < t: the ring is not full yet
    (16, 16, [15, 16, 40]),      # cur >= t: every slot, the ring wrapped
    (8, 16, [3, 7, 8, 29]),      # t < window: a ring of a short prompt's length
])
def test_decode_local_attention_is_flash_decode_on_the_ring(t, window, curs):
    rng = np.random.default_rng(t + window + len(curs))
    b, kh, g, d = len(curs), 2, 3, 16
    q = rng.normal(size=(b, 1, kh * g, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, t, kh, d)).astype(np.float32) for _ in range(2))
    cur = np.asarray(curs, np.int32)
    want = jattn.decode_local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(cur), window)
    got = tattn.decode_local_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(cur), window)
    _close(got, want, 1e-5)


def test_decode_local_attention_refuses_a_ring_longer_than_the_window():
    z = torch.zeros(1, 17, 1, 8)
    with pytest.raises(ValueError, match="exceeds the window"):
        tattn.decode_local_attention(torch.zeros(1, 1, 2, 8), z, z,
                                     torch.zeros(1, dtype=torch.int32), 16)


@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = jax_granite().replace(dtype="float32"), torch_granite().replace(dtype="float32")
    return (jcfg, tcfg) + _models(jcfg, tcfg)


def test_scalar_position_decode_after_extend_cache(granite):
    """Smoke granite: prefill(8) → extend_cache(4) → 4 teacher-forced
    decode steps at a scalar position reproduce prefill(12)'s logits
    (3e-2, as the JAX test) and JAX's own run step for step (f32, 1e-4),
    caches included."""
    jcfg, tcfg, jparams, tparams, jprefill, jdecode = granite
    toks = _tokens(tcfg.vocab_size, (2, 12), 6)
    _, want = tm.prefill(tcfg, tparams, torch.from_numpy(toks))
    jcache, _ = jprefill(jparams, jnp.asarray(toks[:, :8]))
    tcache, _ = tm.prefill(tcfg, tparams, torch.from_numpy(toks[:, :8]))
    jcache = jm.extend_cache(jcfg, jcache, 4)
    tcache = tm.extend_cache(tcfg, tcache, 4)
    assert tcache["stages"][0][0]["k"].shape == (2, 2, 12, 2, tcfg.kq_dim)
    for t in range(8, 12):
        jcache, jl = jdecode(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tcache, tl = tm.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, jl, 1e-4)
    _close(tl, want, 3e-2)
    for name, got, ref in _cache_leaves(jcache, tcache):
        _close(got, ref, 1e-4)


def test_scalar_decode_past_the_arena_clamps_as_jax(granite):
    """A scalar position at or past the arena's end writes the last slot
    (``dynamic_update_slice`` clamps) and attends the whole arena."""
    jcfg, tcfg, jparams, tparams, _, jdecode = granite
    toks = _tokens(tcfg.vocab_size, (2, 1), 7)
    for pos in (5, 6, 9):
        jcache = jm.init_decode_cache(jcfg, 2, 6, pos=pos)
        tcache = tm.init_decode_cache(tcfg, 2, 6, "cpu", pos=pos)
        jcache, jl = jdecode(jparams, jcache, jnp.asarray(toks))
        tcache, tl = tm.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks))
        _close(tl, jl, 1e-4)
        for name, got, ref in _cache_leaves(jcache, tcache):
            _close(got, ref, 1e-4)


def test_extend_cache_leaves_rings_and_states_alone():
    cfg = torch_rg()
    cache = tm.init_decode_cache(cfg, 2, 8, "cpu", pos=8)
    out = tm.extend_cache(cfg, cache, 5)
    for si, stage in enumerate(cache["stages"]):
        for pi, leaves in enumerate(stage):
            for key, x in leaves.items():
                assert out["stages"][si][pi][key] is x
    g = torch_granite()
    cache = tm.init_decode_cache(g, 2, 8, "cpu")
    out = tm.extend_cache(g, cache, 5)
    assert out["stages"][0][0]["k"].shape[2] == 13
    assert cache["stages"][0][0]["k"].shape[2] == 8


def test_step_functions_are_prefill_and_decode_step():
    cfg = torch_rg().replace(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 20), 8))
    c0, l0 = tm.prefill(cfg, params, toks[:, :16])
    c1, l1 = make_prefill_step(cfg)(params, toks[:, :16])
    assert torch.equal(l0, l1)
    for t in (16, 17):
        c0, l0 = tm.decode_step(cfg, params, c0, toks[:, t:t + 1])
        c1, l1 = make_decode_step(cfg)(params, c1, toks[:, t:t + 1])
        assert torch.equal(l0, l1) and torch.equal(c0["pos"], c1["pos"])
    for (_, a, _), (_, b, _) in zip(_cache_leaves(c0, c0), _cache_leaves(c1, c1)):
        assert torch.equal(a, b)


def test_decode_updates_every_cache_leaf_in_place():
    """The decode arena's leaves, RG-LRU ``h``/``conv`` included, are
    written in place and returned as the same tensors."""
    cfg = torch_rg().replace(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    cache = tm.init_decode_cache(cfg, 2, 16, "cpu")
    before = [x.clone() for _, x, _ in _cache_leaves(cache, cache)]
    new, _ = tm.decode_step(cfg, params, cache, torch.ones(2, 1, dtype=torch.int64))
    for (_, a, _), (_, b, _), old in zip(_cache_leaves(cache, cache), _cache_leaves(new, new),
                                         before):
        assert a is b and not torch.equal(a, old)
    assert int(new["pos"]) == 1


def test_per_row_positions_with_a_local_ring_are_refused():
    cfg = torch_rg()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = tm.init_decode_cache(cfg, 2, 16, "cpu", pos=torch.tensor([3, 4]))
    with pytest.raises(ValueError, match="scalar position"):
        tm.decode_step(cfg, params, cache, torch.ones(2, 1, dtype=torch.int64))
