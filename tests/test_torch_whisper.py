"""whisper-tiny in the port against the JAX package, on the CPU.

whisper-tiny is an encoder (``enc_attn`` blocks over stub frontend
frames plus a sinusoidal table) and a decoder of ``dec_attn`` blocks
(causal self-attention with RoPE, cross-attention to the encoder output,
an FFN).  The smoke config (2 + 2 layers, d_model 64, 32 frames), the JAX
parameters carried across by ``params_from_jax``, the same numpy tokens
and frames into both:
  * ``encode`` in f32 to 1e-5 and bf16 to 2e-2, with and without the
    ``proj`` input projection (``d_input`` 48 != ``d_model`` 64), the
    port's train mode (plain ``sdpa``) and prefill mode (the attention
    kernel's plain version, ``causal=False``) alike;
  * ``loss_fn`` and every gradient leaf against ``jax.grad`` in f32 to
    1e-5, under each ``remat``;
  * ``prefill`` logits and the four ``dec_attn`` cache leaves (``k``,
    ``v``, ``ck``, ``cv``), f32 to 1e-5 and bf16 to 2e-2;
  * ``extend_cache`` and teacher-forced decode against JAX's decode and
    JAX's ``prefill(P + T)`` (the port of
    ``tests/test_multihost.py::test_extend_cache_decode_matches_prefill``),
    the cross K/V untouched by decode;
  * per-row ``pos`` decode against JAX's ``decode_step_slots``;
  * ``param_count`` of both full configs this slice adds against JAX's.
JAX's functions are jitted, as its launchers jit them.  Besides,
``ref.edge_probe`` (the card's K4/K6 checks at the 1,500-frame shapes
run on it) is held to its promise on the plain versions: a fault at
the ragged last key tile breaches the kernels' tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as jm
from repro.models.config import EncoderConfig as JaxEncoderConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model as tm
from repro_torch.models.config import EncoderConfig
from repro_torch.models.weights import params_from_jax
from repro_torch.train.steps import make_decode_step, make_prefill_step
from repro_torch.utils.tree import flatten_with_path, path_str, tree_leaves

ARCH = "whisper-tiny"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=what)


def _pair(dtype="float32", d_input=None, remat=None, seed=0):
    jcfg, tcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    kw = {"dtype": dtype}
    if remat is not None:
        kw["remat"] = remat
    jcfg, tcfg = jcfg.replace(**kw), tcfg.replace(**kw)
    if d_input is not None:
        jcfg = jcfg.replace(encoder=dataclasses.replace(jcfg.encoder, d_input=d_input))
        tcfg = tcfg.replace(encoder=dataclasses.replace(tcfg.encoder, d_input=d_input))
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


def _frames(cfg, b, seed):
    enc = cfg.encoder
    return np.random.default_rng(seed).standard_normal(
        (b, enc.num_frames, enc.d_input)).astype(np.float32)


def _j(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _t(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def test_full_config_matches_jax_field_by_field():
    assert ARCH in ARCH_IDS
    got, want = get_config(ARCH), jax_config(ARCH)
    for f in dataclasses.fields(got):
        if f.name != "encoder":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert dataclasses.asdict(got.encoder) == dataclasses.asdict(want.encoder)
    assert isinstance(got.encoder, EncoderConfig) and isinstance(want.encoder, JaxEncoderConfig)
    assert (got.encoder.num_frames, got.encoder.d_input) == (1500, 384)
    assert got.stages == ((("dec_attn",), 4),) and got.encoder.stages == ((("enc_attn",), 4),)
    assert (got.d_model, got.num_heads, got.kq_dim, got.vocab_size) == (384, 6, 64, 51865)


@pytest.mark.parametrize("arch,count", [("whisper-tiny", 56_355_840),
                                        ("qwen2-vl-72b", 72_705_384_448)])
def test_param_count_matches_jax(arch, count):
    assert tm.param_count(get_config(arch)) == jm.param_count(jax_config(arch)) == count


def test_encoder_parameters_carry_across_leaf_for_leaf():
    """The port's ``init_params`` tree has JAX's paths and shapes, the
    ``encoder`` subtree and every ``cross`` leaf included (``proj`` where
    d_input != d_model)."""
    for d_input in (None, 48):
        jcfg, tcfg, jparams, tparams = _pair(d_input=d_input)
        want = [(path_str(p), tuple(x.shape)) for p, x in
                flatten_with_path(jax.tree_util.tree_map(np.asarray, jparams))]
        mine = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        assert [(path_str(p), tuple(x.shape)) for p, x in flatten_with_path(mine)] == want
        paths = [p for p, _ in want]
        assert ("encoder/proj" in paths) == (d_input is not None)
        assert "encoder/norm" in paths and any("/cross/wk" in p for p in paths)


# ---------------------------------------------------------------- encoder


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("d_input", [None, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype, d_input, mode):
    jcfg, tcfg, jparams, tparams = _pair(dtype, d_input)
    frames = _frames(tcfg, 2, 1)
    want, _ = jax.jit(functools.partial(jm.encode, jcfg))(jparams, jnp.asarray(frames))
    got = tm.encode(tcfg, tparams, torch.from_numpy(frames), mode)
    assert got.dtype == tcfg.compute_dtype and tuple(got.shape) == want.shape
    _close(got, want, TOL[dtype])


def test_sinusoidal_table_equals_jax_bit_for_bit():
    from repro.layers.positional import sinusoidal as jsin
    from repro_torch.layers.positional import sinusoidal

    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = sinusoidal(1500, 384, dtype, torch.device("cpu"))
        assert got.dtype == dtype and tuple(got.shape) == (1500, 384)
        np.testing.assert_array_equal(_np(got), _np(jsin(1500, 384, jdt)))
        assert sinusoidal(1500, 384, dtype, torch.device("cpu")) is got  # built once


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_every_gradient_leaf_match_jax(remat):
    jcfg, tcfg, jparams, tparams = _pair(remat=remat)
    toks = _tokens(tcfg.vocab_size, (2, 17), 2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "encoder_frames": _frames(tcfg, 2, 3)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(jcfg, p, b), has_aux=True))(jparams, _j(batch))
    leaves = [p.requires_grad_() for p in tree_leaves(tparams)]
    tl, _ = tm.loss_fn(tcfg, tparams, _t(batch))
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = flatten_with_path(jax.tree_util.tree_map(np.asarray, jg))
    assert len(want) == len(grads)
    for (path, w), g in zip(want, grads):
        _close(g, w, 1e-5, path_str(path))
    enc = [g for (path, _), g in zip(want, grads) if path[0] == "encoder"]
    assert enc and all(float(g.abs().max()) > 0 for g in enc)


# --------------------------------------------------------- prefill, decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_the_four_cache_leaves_match_jax(dtype):
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    toks, ex = _tokens(tcfg.vocab_size, (2, 12), 4), {"encoder_frames": _frames(tcfg, 2, 5)}
    jcache, jlog = jax.jit(functools.partial(jm.prefill, jcfg))(jparams, jnp.asarray(toks),
                                                                _j(ex))
    tcache, tlog = make_prefill_step(tcfg)(tparams, torch.from_numpy(toks), _t(ex))
    _close(tlog, jlog, TOL[dtype])
    leaves = flatten_with_path(tcache["stages"])
    assert sorted({path[-1] for path, _ in leaves}) == ["ck", "cv", "k", "v"]
    for (path, got), want in zip(leaves, jax.tree_util.tree_leaves(jcache["stages"])):
        assert tuple(got.shape) == want.shape and got.dtype == tcfg.compute_dtype, path
        _close(got, want, TOL[dtype], path_str(path))
    ck = tcache["stages"][0][0]["ck"]
    assert tuple(ck.shape) == (2, 2, tcfg.encoder.num_frames, 4, 16)  # (L, B, frames, K, D)
    assert int(tcache["pos"]) == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extend_cache_then_teacher_forced_decode_matches_jax(dtype):
    """prefill(P) -> extend_cache(T) -> T decode steps, each step's logits
    against JAX's, the last against JAX's prefill(P + T); the self K/V
    grows by T, the cross K/V keep their frames and are never written."""
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    p, t = 8, 4
    toks, ex = _tokens(tcfg.vocab_size, (2, p + t), 6), {"encoder_frames": _frames(tcfg, 2, 7)}
    jprefill = jax.jit(functools.partial(jm.prefill, jcfg))
    jdecode = jax.jit(functools.partial(jm.decode_step, jcfg))
    _, want = jprefill(jparams, jnp.asarray(toks), _j(ex))
    jcache, _ = jprefill(jparams, jnp.asarray(toks[:, :p]), _j(ex))
    tcache, _ = tm.prefill(tcfg, tparams, torch.from_numpy(toks[:, :p]), _t(ex))
    jcache, tcache = jm.extend_cache(jcfg, jcache, t), tm.extend_cache(tcfg, tcache, t)
    layer = tcache["stages"][0][0]
    assert layer["k"].shape[2] == p + t and layer["ck"].shape[2] == tcfg.encoder.num_frames
    cross = [layer["ck"].clone(), layer["cv"].clone()]
    decode = make_decode_step(tcfg)
    for i in range(p, p + t):
        jcache, jlog = jdecode(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        tcache, tlog = decode(tparams, tcache, torch.from_numpy(toks[:, i:i + 1]))
        _close(tlog, jlog, TOL[dtype], f"step {i}")
    _close(tlog, want, {"float32": 1e-5, "bfloat16": 3e-2}[dtype], "vs prefill(P + T)")
    assert torch.equal(layer["ck"], cross[0]) and torch.equal(layer["cv"], cross[1])
    for got, w in zip(tree_leaves(tcache["stages"]), jax.tree_util.tree_leaves(jcache["stages"])):
        _close(got, w, TOL[dtype])


def test_per_row_positions_match_jax_decode_step_slots():
    """Rows at their own positions (one rewinds into its prompt, one past
    the arena's end) decode as JAX's ``decode_step_slots``: logits and
    every cache leaf, f32."""
    jcfg, tcfg, jparams, tparams = _pair()
    toks, ex = _tokens(tcfg.vocab_size, (3, 10), 8), {"encoder_frames": _frames(tcfg, 3, 9)}
    jcache, _ = jax.jit(functools.partial(jm.prefill, jcfg))(jparams, jnp.asarray(toks), _j(ex))
    tcache, _ = tm.prefill(tcfg, tparams, torch.from_numpy(toks), _t(ex))
    jcache, tcache = jm.extend_cache(jcfg, jcache, 4), tm.extend_cache(tcfg, tcache, 4)
    pos = np.array([10, 6, 14], np.int32)
    jcache["pos"], tcache["pos"] = jnp.asarray(pos), torch.from_numpy(pos.copy())
    jslots = jax.jit(functools.partial(jm.decode_step_slots, jcfg))
    step = _tokens(tcfg.vocab_size, (3, 3), 10)
    for i in range(3):
        jcache, jlog = jslots(jparams, jcache, jnp.asarray(step[:, i:i + 1]))
        tcache, tlog = tm.decode_step(tcfg, tparams, tcache, torch.from_numpy(step[:, i:i + 1]))
        _close(tlog, jlog, 1e-5, f"step {i}")
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for got, w in zip(tree_leaves(tcache["stages"]), jax.tree_util.tree_leaves(jcache["stages"])):
        _close(got, w, 1e-5)


def test_init_decode_cache_has_zero_cross_leaves_of_the_encoders_frames():
    cfg = get_config(ARCH, smoke=True)
    cache = tm.init_decode_cache(cfg, 2, 8, "cpu")
    layer = cache["stages"][0][0]
    assert sorted(layer) == ["ck", "cv", "k", "v"]
    assert tuple(layer["ck"].shape) == (2, 2, cfg.encoder.num_frames, 4, 16)
    assert tuple(layer["k"].shape) == (2, 2, 8, 4, 16)


# ------------------------------------------------------------------ refusals


def test_batch_extras_are_refused_by_name():
    """A missing ``encoder_frames`` and an extra the config would not read
    (JAX would drop it silently) raise, naming the key."""
    _, tcfg, _, tparams = _pair()
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, (2, 9), 11))
    frames = torch.from_numpy(_frames(tcfg, 2, 12))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with pytest.raises(ValueError, match="encoder_frames"):
        tm.loss_fn(tcfg, tparams, batch)
    with pytest.raises(ValueError, match="encoder_frames"):
        tm.prefill(tcfg, tparams, toks)
    with pytest.raises(ValueError, match="positions_3d"):
        tm.loss_fn(tcfg, tparams, dict(batch, encoder_frames=frames,
                                       positions_3d=torch.zeros(2, 3, 8, dtype=torch.int32)))
    cache, _ = tm.prefill(tcfg, tparams, toks, {"encoder_frames": frames})
    with pytest.raises(ValueError, match="encoder_frames"):  # decode reads the cache's
        tm.decode_step(tcfg, tparams, cache, toks[:, :1], {"encoder_frames": frames})


def test_train_launcher_refuses_whisper_naming_encoder_frames():
    from repro_torch.launch import train as launch

    with pytest.raises(ValueError, match="encoder_frames"):
        launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1"])


def test_enc_attn_has_no_decode_cache():
    from repro_torch.models.blocks import init_cache

    with pytest.raises(ValueError, match="enc_attn"):
        init_cache("enc_attn", get_config(ARCH, smoke=True), 1, 4, "cpu")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_edge_probe_makes_ragged_tile_faults_breach_the_kernel_tolerance(dtype, tol):
    """On ``ref.edge_probe``'s inputs at T = 1,500 (no whole number of
    64-key tiles), the plain attention with zero keys appended to 1,536,
    cut to 1,472 keys, or decode one key short, each lies outside ``tol
    + tol·|want|`` of the true answer.  In bf16, N(0, 1) inputs keep the
    zero keys inside it."""
    from repro_torch.kernels import ref

    def breaches(got, want):
        got, want = got.float(), want.float()
        return bool(((got - want).abs() > tol + tol * want.abs()).any())

    def pad(x):
        return torch.cat([x, x.new_zeros(x.shape[0], 36, *x.shape[2:])], 1)

    g = torch.Generator().manual_seed(0)
    q, k, v = ref.edge_probe((2, 16, 6, 64), (2, 1500, 6, 64), dtype, g)
    want = ref.flash_attention(q, k, v, causal=False)
    assert breaches(ref.flash_attention(q, pad(k), pad(v), causal=False), want)
    assert breaches(ref.flash_attention(q, k[:, :1472], v[:, :1472], causal=False), want)
    cur = torch.full((2,), 1499, dtype=torch.int32)
    want = ref.flash_decode(q[:, 0], k, v, cur)
    assert breaches(ref.flash_decode(q[:, 0], k, v, cur - 1), want)
    assert breaches(ref.flash_decode(q[:, 0], pad(k), pad(v), cur + 36), want)
    if dtype == torch.bfloat16:
        rq, rk, rv = (torch.randn(x.shape, generator=g).to(dtype) for x in (q, k, v))
        want = ref.flash_attention(rq, rk, rv, causal=False)
        assert not breaches(ref.flash_attention(rq, pad(rk), pad(rv), causal=False), want)
