"""qwen2-vl-72b's M-RoPE and the position extras in the port against the
JAX package, on the CPU.

M-RoPE splits RoPE's frequency bands over three position streams
(temporal, height, width; sections (16, 24, 24) at head dim 128), read
from the batch extra ``positions_3d`` (B, 3, S); a RoPE config reads
``positions`` (B, S).  Held here, the JAX parameters carried across by
``params_from_jax`` and the same numpy inputs into both:
  * ``mrope_angles`` against JAX's bit for bit;
  * ``loss_fn`` with ``positions_3d`` (smoke qwen2-vl) and with
    ``positions`` (smoke granite): the loss, f32 to 1e-5 and bf16 to
    2e-2, and f32 gradients to 1e-5;
  * prefill and decode with per-step ``positions_3d`` (B, 3, 1) against
    JAX's ``prefill`` and ``decode_step(..., extras)``, positions laid out
    as Qwen2-VL lays out text around an image (arXiv:2409.12191, §2.1);
  * a microbatched train step with the extras split by rows, against
    JAX's;
  * the training launcher on ``qwen2-vl-72b --smoke --device cpu``
    (default positions, as JAX's launcher) against JAX's launcher.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.layers.positional import mrope_angles as jax_mrope
from repro.models import model as jm
from repro.train import optimizer as jopt
from repro.train.steps import make_train_step as jax_train_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.layers.positional import mrope_angles, rope_angles, vl_positions
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.utils.tree import flatten_with_path, path_str, tree_leaves

ARCH = "qwen2-vl-72b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=what)


def _pair(arch=ARCH, dtype="float32", seed=0):
    jcfg = jax_config(arch, smoke=True).replace(dtype=dtype)
    tcfg = get_config(arch, smoke=True).replace(dtype=dtype)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


def qwen2vl_positions(b, n, image_at, grid=(3, 4)):
    """(b, 3, n) int32 numpy ``vl_positions``, row r's image at token
    ``image_at + r``."""
    return np.stack([vl_positions(n, image_at + r, grid).numpy() for r in range(b)])


def test_full_config_matches_jax_field_by_field():
    assert ARCH in ARCH_IDS
    got, want = get_config(ARCH), jax_config(ARCH)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.mrope_sections == (16, 24, 24) and got.kq_dim == 128
    assert (got.num_layers, got.d_model, got.num_heads, got.num_kv_heads) == (80, 8192, 64, 8)


@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)), (16, (2, 3, 3)),
                                               (64, (32, 0, 0))])
def test_mrope_angles_equal_jax_bit_for_bit(head_dim, sections):
    pos = np.random.default_rng(head_dim).integers(0, 40_000, (3, 3, 37)).astype(np.int32)
    got = mrope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    want = np.asarray(jax_mrope(jnp.asarray(pos), head_dim, 1e6, sections))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 37, head_dim // 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mrope_of_three_equal_streams_is_rope():
    pos = torch.arange(50, dtype=torch.int32)[None].repeat(2, 1)
    got = mrope_angles(torch.stack([pos, pos, pos], 1), 128, 1e4, (16, 24, 24))
    assert torch.equal(got, rope_angles(pos, 128, 1e4))


def test_mrope_sections_must_cover_half_the_head_dim():
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        mrope_angles(torch.zeros(1, 3, 4, dtype=torch.int32), 128, 1e4, (16, 24, 16))


def test_qwen2vl_positions_follow_the_papers_layout():
    p = qwen2vl_positions(1, 20, 2)[0]
    assert p[:, :2].tolist() == [[0, 1]] * 3               # text
    assert p[0, 2:14].tolist() == [2] * 12                 # the image: t fixed
    assert p[1, 2:14].tolist() == [2 + r for r in range(3) for _ in range(4)]
    assert p[2, 2:14].tolist() == [2 + c for _ in range(3) for c in range(4)]
    assert p[:, 14].tolist() == [6, 6, 6]                  # text resumes at 2 + 3 + 1
    assert p[:, 19].tolist() == [11, 11, 11]


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,key", [(ARCH, "positions_3d"), ("granite-3-8b", "positions")])
def test_loss_with_position_extras_matches_jax(arch, key, dtype):
    jcfg, tcfg, jparams, tparams = _pair(arch, dtype)
    toks = _tokens(tcfg.vocab_size, (2, 21), 1)
    pos = qwen2vl_positions(2, 20, 3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             key: pos if key == "positions_3d" else pos[:, 1] + 5}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(jcfg, p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [p.requires_grad_() for p in tree_leaves(tparams)]
    tl, _ = tm.loss_fn(tcfg, tparams, tb)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL[dtype])
    # the extra moves the loss: it is read, not dropped
    plain, _ = tm.loss_fn(tcfg, tparams, {"tokens": tb["tokens"], "labels": tb["labels"]})
    assert abs(float(plain.detach()) - float(tl.detach())) > 1e-4
    if dtype == "float32":
        grads = torch.autograd.grad(tl, leaves)
        for (path, w), g in zip(flatten_with_path(jax.tree_util.tree_map(np.asarray, jg)), grads):
            _close(g, w, 1e-5, path_str(path))


def test_a_rope_config_refuses_positions_3d_and_qwen2vl_refuses_positions():
    for arch, key, shape in (("granite-3-8b", "positions_3d", (2, 3, 8)),
                             (ARCH, "positions", (2, 8))):
        _, tcfg, _, tparams = _pair(arch)
        toks = torch.from_numpy(_tokens(tcfg.vocab_size, (2, 8), 2))
        with pytest.raises(ValueError, match=key):
            tm.loss_fn(tcfg, tparams, {"tokens": toks, "labels": toks,
                                       key: torch.zeros(shape, dtype=torch.int32)})


# --------------------------------------------------------- prefill, decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_with_per_step_positions_3d_match_jax(dtype):
    """prefill of a 16-token prompt with an image block, ``extend_cache``
    by 6, then 6 decode steps each carrying its (B, 3, 1) positions:
    logits each step and every K/V leaf, against JAX."""
    jcfg, tcfg, jparams, tparams = _pair(ARCH, dtype)
    p, t = 16, 6
    toks = _tokens(tcfg.vocab_size, (2, p + t), 3)
    pos = qwen2vl_positions(2, p + t, 2)
    jcache, jlog = jax.jit(functools.partial(jm.prefill, jcfg))(
        jparams, jnp.asarray(toks[:, :p]), {"positions_3d": jnp.asarray(pos[:, :, :p])})
    tcache, tlog = make_prefill_step(tcfg)(tparams, torch.from_numpy(toks[:, :p]),
                                           {"positions_3d": torch.from_numpy(pos[:, :, :p])})
    _close(tlog, jlog, TOL[dtype], "prefill")
    jcache, tcache = jm.extend_cache(jcfg, jcache, t), tm.extend_cache(tcfg, tcache, t)
    jdecode = jax.jit(functools.partial(jm.decode_step, jcfg))
    decode = make_decode_step(tcfg)
    for i in range(p, p + t):
        step = pos[:, :, i:i + 1]
        jcache, jlog = jdecode(jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                               {"positions_3d": jnp.asarray(step)})
        tcache, tlog = decode(tparams, tcache, torch.from_numpy(toks[:, i:i + 1]),
                              {"positions_3d": torch.from_numpy(step)})
        _close(tlog, jlog, TOL[dtype], f"step {i}")
    for got, w in zip(tree_leaves(tcache["stages"]), jax.tree_util.tree_leaves(jcache["stages"])):
        _close(got, w, TOL[dtype])


def test_teacher_forced_decode_with_positions_3d_matches_prefill():
    """The form of ``chip_smoke.py``'s qwen2-vl check: prefill of a prompt
    against as many decode steps from an empty cache, each with its
    (1, 3, 1) positions, f32 to 1e-5; the default positions give other
    logits."""
    _, tcfg, _, tparams = _pair()
    n = 24
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, (1, n), 4))
    pos = torch.from_numpy(qwen2vl_positions(1, n, 5))
    _, want = tm.prefill(tcfg, tparams, toks, {"positions_3d": pos})
    _, default = tm.prefill(tcfg, tparams, toks)
    cache = tm.init_decode_cache(tcfg, 1, n, "cpu")
    for i in range(n):
        cache, got = tm.decode_step(tcfg, tparams, cache, toks[:, i:i + 1],
                                    {"positions_3d": pos[:, :, i:i + 1]})
    _close(got, want, 1e-5)
    assert float((default - want).abs().max()) > 1e-3


# ------------------------------------------------------ train step, launcher


@pytest.mark.parametrize("arch", [ARCH, "whisper-tiny"])
def test_microbatched_step_splits_the_extras_as_jax(arch):
    """microbatches=2 with ``positions_3d`` or ``encoder_frames`` in the
    batch: every entry split by rows, the loss and gradient norm against
    JAX's microbatched step, the gradients (first moments) to 1e-4 of
    each leaf's largest entry."""
    jcfg, tcfg, jparams, _ = _pair(arch)
    toks = _tokens(tcfg.vocab_size, (4, 13), 5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if tcfg.encoder is not None:
        enc = tcfg.encoder
        batch["encoder_frames"] = np.random.default_rng(6).standard_normal(
            (4, enc.num_frames, enc.d_input)).astype(np.float32)
    else:
        batch["positions_3d"] = qwen2vl_positions(4, 12, 1)
    opt_cfg = dict(lr=3e-3, warmup_steps=2)
    jo = jopt.AdamW(jopt.AdamWConfig(**opt_cfg))
    jstate = {"params": jparams, "opt": jo.init(jparams), "step": jnp.zeros((), jnp.int32)}
    jstate, jout = jax.jit(jax_train_step(jcfg, jo, microbatches=2))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    to = AdamW(AdamWConfig(**opt_cfg))
    state = {"params": params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))}
    state.update(opt=to.init(state["params"]), step=torch.zeros((), dtype=torch.int32))
    state, out = make_train_step(tcfg, to, microbatches=2)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]), float(jout["grad_norm"]), rtol=1e-4)
    for got, want in zip(tree_leaves(state["opt"]["mu"]),
                         jax.tree_util.tree_leaves(jstate["opt"]["mu"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max() + 1e-30))


def test_train_launcher_smoke_matches_the_jax_launcher(monkeypatch):
    """``python -m repro_torch.launch.train --arch qwen2-vl-72b --smoke``
    on the CPU against ``repro.launch.train`` with the same flags: both
    in f32, default M-RoPE positions (the launchers' batches carry tokens
    and labels), the port on JAX's weights for the launcher's seed, the
    same record file and shuffle.  The final loss to 1e-5."""
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
