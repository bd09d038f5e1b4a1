"""The port's serving model functions against the JAX package.

Smoke granite in float32 with the JAX parameters carried across by
``params_from_jax``: ``prefill_at`` (logits and KV), ``write_prefill_slot``
and ``decode_step`` with mixed per-row positions (JAX's
``decode_step_slots``), including rows at or past the arena's end (the
engine keeps advancing idle slots), agree at rtol/atol 1e-4.  A bf16 run agrees on logits at 3e-2 (the two frameworks
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
        tarena, tl = tm.decode_step(tcfg, tparams, tarena, torch.from_numpy(step))
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
    cfg = torch_smoke().replace(stages=((("attn", "dec_attn"), 1),))
    with pytest.raises(NotImplementedError, match="dec_attn"):
        tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


# ----------------------------------------------------- blocked attention


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("s,block", [(64, 16), (48, 16), (40, 16), (16, 16)])
def test_blocked_attention_matches_jax(dtype, tol, s, block):
    """The online softmax over key blocks against JAX's function: f32 to
    1e-6 (``test_blocked_attention_equivalence``'s gate), bf16 to 2e-2 (p
    rounded to bf16 before P·V in both, products summed in another
    order).  s = 40 and s = 16 take JAX's full-attention branch."""
    from repro.layers import attention as jattn
    from repro_torch.layers import attention as tattn

    rng = np.random.default_rng(s + block)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, s, 2, 16)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jattn.blocked_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), block)
    got = tattn.blocked_attention(*(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
                                  block)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 5e-4)])
def test_blocked_loss_and_grads_match_full(dtype, tol):
    """``attn_impl="blocked"`` in training against ``"full"``: the loss to
    ``test_blocked_attention_equivalence``'s gates (f32 1e-6, bf16 5e-4)
    and the f32 loss to JAX's blocked loss at 1e-5; gradients finite and,
    in f32, within 1e-5 of full's relative to each leaf's largest entry."""
    from repro_torch.utils.tree import tree_leaves, tree_unflatten

    jcfg = jax_smoke().replace(dtype=dtype)
    tcfg = torch_smoke().replace(dtype=dtype)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    toks = _tokens(tcfg, (2, 64), 9)
    labels = np.roll(toks, -1, axis=1)
    out = {}
    for impl in ("full", "blocked"):
        cfg = tcfg.replace(attn_impl=impl, attn_block=16)
        leaves = [p.clone().requires_grad_() for p in tree_leaves(tparams)]
        loss, _ = tm.loss_fn(cfg, tree_unflatten(tparams, leaves),
                             {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
        out[impl] = (loss.detach(), torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(float(out["blocked"][0]), float(out["full"][0]), rtol=tol)
    assert all(torch.isfinite(g).all() for g in out["blocked"][1])
    if dtype == "float32":
        for g, f in zip(out["blocked"][1], out["full"][1]):
            np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(f.abs().max() + 1e-30))
        jl, _ = jm.loss_fn(jcfg.replace(attn_impl="blocked", attn_block=16), jparams,
                           {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        np.testing.assert_allclose(float(out["blocked"][0]), float(jl), rtol=1e-5)


def test_blocked_prefill_matches_jax():
    """Prefill at ``attn_impl="blocked"`` (the blocked branch at s = 32,
    block 8), f32: logits and K/V to 1e-4."""
    jcfg = jax_smoke().replace(dtype="float32", attn_impl="blocked", attn_block=8)
    tcfg = torch_smoke().replace(dtype="float32", attn_impl="blocked", attn_block=8)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    toks = _tokens(tcfg, (2, 32), 10)
    jc, jl = jm.prefill(jcfg, jparams, jnp.asarray(toks))
    tc, tl = tm.prefill(tcfg, tparams, torch.from_numpy(toks))
    _close(tl, jl, "float32")
    for key in ("k", "v"):
        _close(tc["stages"][0][0][key], jc["stages"][0][0][key], "float32")


def test_unknown_attn_impl_is_refused():
    cfg = torch_smoke().replace(attn_impl="flash")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        tm.prefill(cfg, params, torch.ones(1, 4, dtype=torch.int64))
