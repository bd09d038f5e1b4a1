"""stablelm-12b in the port against the JAX package, on the CPU.

stablelm-12b is a plain ``attn`` stack whose head dim is 160; the card's
attention kernels (K4 ``flash_attention``, K6 ``flash_decode``) take it
since this config was copied.  Here:
  * the full config equals JAX's field by field (JAX's sharding and
    reduction knobs, which the port has no counterpart for, at their
    defaults), and ``param_count``
    (12,142,924,800) equals JAX's;
  * a 2-layer model at head dim 160 with stablelm's group 4 (8 query heads
    on 2 KV heads; the smoke config's widths otherwise), the JAX
    parameters carried across by ``params_from_jax``, in float32: the
    training loss to 1e-5 (relative), the prefill logits and every K/V
    leaf, then 8 decode steps after ``extend_cache``, to 1e-4 (sums taken
    in another order), as ``tests/test_torch_moe.py`` holds the copied
    configs.
The kernels' plain versions at head dim 160 are held against the Pallas
kernels in ``tests/test_torch_kernels.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import model as jm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax
from repro_torch.utils.tree import flatten_with_path, tree_leaves

ARCH = "stablelm-12b"


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_full_config_matches_jax_field_by_field():
    assert ARCH in ARCH_IDS
    got, want = get_config(ARCH), jax_config(ARCH)
    names = [f.name for f in dataclasses.fields(got)]
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    # JAX's reduction knob the port has no counterpart for, left at its
    # default by the config
    extra = {f.name: f.default for f in dataclasses.fields(want) if f.name not in names}
    assert set(extra) == {"matmul_reduce_dtype"}
    assert all(getattr(want, n) == d for n, d in extra.items())
    assert (got.num_layers, got.d_model, got.kq_dim) == (40, 5120, 160)
    assert (got.num_heads, got.num_kv_heads, got.d_ff, got.vocab_size) == (32, 8, 13824, 100352)


def test_param_count_matches_jax():
    assert tm.param_count(get_config(ARCH)) == jm.param_count(jax_config(ARCH)) == 12_142_924_800


def _pair():
    kw = dict(dtype="float32", head_dim=160, num_heads=8, num_kv_heads=2)
    jcfg = jax_config(ARCH, smoke=True).replace(**kw)
    tcfg = get_config(ARCH, smoke=True).replace(**kw)
    assert tcfg.num_layers == 2
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(21))
    return jcfg, tcfg, jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


def test_head_dim_160_model_loss_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair()
    toks = _tokens(tcfg.vocab_size, (2, 17), 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, _ = jax.jit(functools.partial(jm.loss_fn, jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = tm.loss_fn(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_head_dim_160_model_prefill_and_decode_match_jax():
    """``prefill`` of 12 tokens, ``extend_cache`` by 8, then 8 scalar-position
    ``decode_step``s: logits and the K/V caches (head dim 160) each step."""
    jcfg, tcfg, jparams, tparams = _pair()
    toks = _tokens(tcfg.vocab_size, (2, 20), 2)
    jcache, jlog = jax.jit(functools.partial(jm.prefill, jcfg))(jparams, jnp.asarray(toks[:, :12]))
    tcache, tlog = tm.prefill(tcfg, tparams, torch.from_numpy(toks[:, :12]))
    _close(tlog, jlog, 1e-4)
    for (path, got), want in zip(flatten_with_path(tcache["stages"]),
                                 jax.tree_util.tree_leaves(jcache["stages"])):
        assert got.shape == want.shape and got.shape[-1] == 160, path
        _close(got, want, 1e-4)
    jcache, tcache = jm.extend_cache(jcfg, jcache, 8), tm.extend_cache(tcfg, tcache, 8)
    jdecode = jax.jit(functools.partial(jm.decode_step, jcfg))
    for i in range(12, 20):
        jcache, jlog = jdecode(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        tcache, tlog = tm.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks[:, i:i + 1]))
        _close(tlog, jlog, 1e-4)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 20
    for got, want in zip(tree_leaves(tcache["stages"]), jax.tree_util.tree_leaves(jcache["stages"])):
        _close(got, want, 1e-4)
