"""The port's serving model functions against the JAX package.

Smoke granite in float32 with the JAX parameters carried across by
``params_from_jax``: ``prefill_at`` (logits and KV), ``write_prefill_slot``
and ``decode_step_slots`` with mixed per-row positions, including rows at
or past the arena's end (the engine keeps advancing idle slots), agree at
rtol/atol 1e-4.  A bf16 run agrees on logits at 3e-2 (the two frameworks
round bf16 at different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.granite_3_8b import smoke_config as jax_smoke
from repro.models import model as jm
from repro_torch.configs.granite_3_8b import smoke_config as torch_smoke
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jcfg = jax_smoke().replace(dtype=dtype)
    tcfg = torch_smoke().replace(dtype=dtype)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return dtype, jcfg, jparams, tcfg, tparams


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, size=shape).astype(np.int32)


def test_params_carry_leaf_for_leaf(pair):
    _, _, jparams, _, tparams = pair
    jl, jdef = jax.tree_util.tree_flatten(jparams)
    tl, tdef = jax.tree_util.tree_flatten(tparams)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_prefill_at_logits_and_kv(pair):
    dtype, jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(tcfg, (2, 9), 1)
    lens = np.asarray([5, 9], np.int32)
    jc, jl = jm.prefill_at(jcfg, jparams, jnp.asarray(toks), jnp.asarray(lens))
    tc, tl = tm.prefill_at(tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(lens))
    _close(tl, jl, dtype)
    if dtype == "float32":
        for key in ("k", "v"):
            _close(tc["stages"][0][0][key], jc["stages"][0][0][key], dtype)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_write_prefill_slot_then_decode_mixed_positions(pair):
    """Slot insert into a live arena, then per-row decode where rows sit at
    the start, the middle, the last slot and past the end (C = 12)."""
    dtype, jcfg, jparams, tcfg, tparams = pair
    b, cap = 5, 12
    rng = np.random.default_rng(2)
    layers = tcfg.num_layers
    shape = (layers, b, cap, tcfg.num_kv_heads, tcfg.kq_dim)
    kv = {k: rng.normal(size=shape).astype(np.float32) for k in ("k", "v")}
    pos = np.asarray([0, 4, 11, 12, 17], np.int32)

    jarena = jm.init_decode_cache(jcfg, b, cap, pos=jnp.asarray(pos))
    jarena["stages"][0][0].update({k: jnp.asarray(x, jcfg.compute_dtype) for k, x in kv.items()})
    tarena = tm.init_decode_cache(tcfg, b, cap, "cpu", pos=torch.from_numpy(pos))
    for k, x in kv.items():
        tarena["stages"][0][0][k].copy_(torch.from_numpy(x))

    toks = _tokens(tcfg, (1, 7), 3)
    jpre, _ = jm.prefill_at(jcfg, jparams, jnp.asarray(toks), jnp.asarray([6], jnp.int32))
    tpre, _ = tm.prefill_at(tcfg, tparams, torch.from_numpy(toks), torch.tensor([6], dtype=torch.int32))
    jarena = jm.write_prefill_slot(jcfg, jarena, 1, jpre)
    tarena = tm.write_prefill_slot(tcfg, tarena, 1, tpre)
    np.testing.assert_array_equal(tarena["pos"].numpy(), np.asarray(jarena["pos"]))

    step = _tokens(tcfg, (b, 1), 4)
    for _ in range(2):
        jarena, jl = jm.decode_step_slots(jcfg, jparams, jarena, jnp.asarray(step))
        tarena, tl = tm.decode_step_slots(tcfg, tparams, tarena, torch.from_numpy(step))
        _close(tl, jl, dtype)
        step = np.array(jnp.argmax(jl, -1), np.int32).reshape(b, 1)
    np.testing.assert_array_equal(tarena["pos"].numpy(), np.asarray(jarena["pos"]))
    if dtype == "float32":
        for key in ("k", "v"):
            _close(tarena["stages"][0][0][key], jarena["stages"][0][0][key], dtype)


def test_init_params_on_generator_is_deterministic():
    cfg = torch_smoke()
    a = tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    wq = a["stages"][0][0]["attn"]["wq"]
    assert wq.shape == (2, cfg.d_model, cfg.num_heads, cfg.kq_dim)
    assert wq.dtype == torch.float32
    torch.testing.assert_close(wq, b["stages"][0][0]["attn"]["wq"], rtol=0, atol=0)
    # truncated normal in [-2, 2] times the fan-in scale
    assert wq.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-7
    assert not torch.equal(wq[0], wq[1])  # layers drawn independently


def test_refuses_unported_block_kinds():
    cfg = torch_smoke().replace(stages=((("attn", "mlstm"), 1),))
    with pytest.raises(NotImplementedError, match="mlstm"):
        tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
