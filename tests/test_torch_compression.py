"""The port's gradient compression (``repro_torch.train.compression``)
against the JAX package's, on the CPU.

Held exactly (``torch.equal`` / ``np.array_equal``): ``quantize`` codes
and scales, ``EFCompressor``'s codes, scales, residuals and decompressed
trees, EF-SGD's trajectory on a quadratic, and ``compressed_psum`` over
4 gloo ranks against JAX's under ``jax.vmap(axis_name="dp")`` on the same
4 shards.  Error feedback's invariant ``decompress + new_residual ==
grad + residual`` holds bit for bit (Sterbenz: the subtraction that makes
the residual is exact).

The compressed train step of smoke recurrentgemma (f32, JAX's weights)
is held for 3 steps, each from the JAX state the step before left: the
loss to 1e-5 relative and the compressed error ``e = grad + residual`` to
1e-4 of each leaf's largest entry (``tests/test_torch_train.py``'s
gradient tolerance).  The codes then agree but where ``e`` lies within
that tolerance of a rounding boundary (``|residual|`` within 3% of half a
scale unit), and differ there by one; the first moments and weights are
held as the step parity holds them, with the flipped codes' share added.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _hypo import given, settings, st
from _torch_dist import run_ranks

from repro.configs.recurrentgemma_2b import smoke_config as jax_smoke
from repro.models import model as jm
from repro.train import compression as jc
from repro.train import optimizer as jopt
from repro.train.steps import make_train_step as jax_train_step
from repro_torch.configs.recurrentgemma_2b import smoke_config as torch_smoke
from repro_torch.models.weights import params_from_jax
from repro_torch.train.compression import (
    EFCompressor,
    compressed_psum,
    dequantize,
    quantize,
)
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.utils.tree import tree_leaves

VOCAB = 128


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- quantize
QUANT_CASES = [(seed, scale, bits, "float32") for seed in (0, 1) for scale in (1e-3, 1.0, 1e3)
               for bits in (4, 8)] + [(2, 1.0, 8, "bfloat16"), (3, 1e2, 4, "bfloat16")]


@pytest.mark.parametrize("seed,scale,bits,dtype", QUANT_CASES)
def test_quantize_matches_jax(seed, scale, bits, dtype):
    x = (np.random.default_rng(seed).normal(size=(1000,)) * scale).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = _t(x).to(getattr(torch, dtype))
    codes, s = quantize(tx, bits)
    jcodes, js = jc.quantize(jx, bits)
    assert codes.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert torch.equal(codes, _t(jcodes)) and torch.equal(s, _t(js))
    assert torch.equal(dequantize(codes, s), _t(jc.dequantize(jcodes, js)))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_zero_leaf_floors_the_scale(bits):
    codes, s = quantize(torch.zeros(7), bits)
    jcodes, js = jc.quantize(jnp.zeros(7), bits)
    assert float(s) == float(js) == np.float32(1e-30)
    assert codes.dtype == (torch.int8 if bits <= 8 else torch.int32)
    assert torch.equal(codes, _t(jcodes)) and not codes.any()


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 1000), scale=st.floats(1e-3, 1e3), bits=st.sampled_from([4, 8]))
def test_quantization_error_bound(seed, scale, bits):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(64,)) * scale).float()
    back = dequantize(*quantize(x, bits))
    bound = float(x.abs().max()) / ((1 << (bits - 1)) - 1) / 2 + 1e-6
    assert float((back - x).abs().max()) <= bound * 1.001


# --------------------------------------------------------- EF compressor
def _tree(rng, scale):
    return {"b": [rng.normal(size=(5, 3)) * scale, (rng.normal(size=(4,)) * scale,)],
            "a": rng.normal(size=(2, 3, 2)) * scale, "z": np.zeros(3)}


@pytest.mark.parametrize("bits", [4, 8])
def test_ef_compressor_matches_jax(bits):
    """Three rounds, each feeding back the residual: every leaf of the
    codes, scales, residual and decompressed tree equal to JAX's."""
    rng = np.random.default_rng(bits)
    comp, jcomp = EFCompressor(bits), jc.EFCompressor(bits)
    template = _tree(rng, 1.0)
    res = comp.init(params_from_jax(template))
    jres = jcomp.init(jax.tree_util.tree_map(jnp.asarray, template))
    for i in range(3):
        g = jax.tree_util.tree_map(lambda x: x.astype(np.float32), _tree(rng, 10.0 ** (i - 1)))
        (codes, scales), res = comp.compress(params_from_jax(g), res)
        (jcodes, jscales), jres = jcomp.compress(jax.tree_util.tree_map(jnp.asarray, g), jres)
        got = (codes, scales, res, comp.decompress((codes, scales)))
        want = (jcodes, jscales, jres, jcomp.decompress((jcodes, jscales)))
        for t, j in zip(got, want):
            assert jax.tree_util.tree_structure(_np(j)) == jax.tree_util.tree_structure(
                jax.tree_util.tree_map(lambda x: x.numpy(), t))
            for a, b in zip(tree_leaves(t), jax.tree_util.tree_leaves(j)):
                assert torch.equal(a, _t(b))


@pytest.mark.parametrize("seed", range(4))
def test_error_feedback_invariant_is_exact(seed):
    """``decompress(compressed) + new_residual == grad + residual``, bit
    for bit, over leaves whose scales span twelve decades."""
    rng = np.random.default_rng(seed)
    comp = EFCompressor(8)
    grads = [torch.from_numpy(rng.normal(size=(300,)) * 10.0 ** k).float() for k in range(-6, 7)]
    res = [torch.from_numpy(rng.normal(size=(300,)) * 10.0 ** (k - 3)).float()
           for k in range(-6, 7)]
    compressed, new_res = comp.compress(grads, res)
    for d, r, g, r0 in zip(comp.decompress(compressed), new_res, grads, res):
        assert torch.equal(d + r, g + r0)


def test_error_feedback_accumulates_exactly():
    """Over 200 steps the sent sum plus the residual is the true sum, and
    the residual stays bounded; every step equal to JAX's."""
    comp, jcomp = EFCompressor(8), jc.EFCompressor(8)
    res, jres = comp.init({"w": torch.zeros(32)}), jcomp.init({"w": jnp.zeros((32,))})
    rng = np.random.default_rng(0)
    total_true, total_sent = np.zeros(32), np.zeros(32)
    for _ in range(200):
        g = (rng.normal(size=32) * 0.1).astype(np.float32)
        total_true += g
        compressed, res = comp.compress({"w": _t(g)}, res)
        jcompressed, jres = jcomp.compress({"w": jnp.asarray(g)}, jres)
        sent = comp.decompress(compressed)["w"]
        assert torch.equal(sent, _t(jcomp.decompress(jcompressed)["w"]))
        assert torch.equal(res["w"], _t(jres["w"]))
        total_sent += sent.numpy()
    np.testing.assert_allclose(total_sent + res["w"].numpy(), total_true, rtol=1e-4, atol=1e-4)
    assert float(res["w"].abs().max()) < 0.01


def test_ef_sgd_converges_on_quadratic():
    """4-bit EF-SGD reaches plain SGD's optimum; every iterate equal to
    JAX's."""
    comp, jcomp = EFCompressor(bits=4), jc.EFCompressor(bits=4)
    w, jw = torch.tensor([5.0, -3.0, 2.0]), jnp.asarray([5.0, -3.0, 2.0])
    target, jtarget = torch.tensor([1.0, 2.0, -1.0]), jnp.asarray([1.0, 2.0, -1.0])
    res, jres = comp.init({"w": w})["w"], jcomp.init({"w": jw})["w"]
    for _ in range(500):
        (codes, scale), res = comp.compress({"w": 2 * (w - target)}, {"w": res})
        res = res["w"]
        w = w - 0.05 * dequantize(codes["w"], scale["w"])
        (jcodes, jscale), jres = jcomp.compress({"w": 2 * (jw - jtarget)}, {"w": jres})
        jres = jres["w"]
        jw = jw - 0.05 * jc.dequantize(jcodes["w"], jscale["w"])
        assert torch.equal(w, _t(jw))
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=2e-2)


# ------------------------------------------------------ compressed_psum
PSUM_SHAPES = [((4, 1000), 8, 0), ((4, 1000), 4, 1), ((4, 33, 7), 8, 2), ((4, 5), 8, 3)]


@pytest.fixture(scope="module")
def psum_ranks(tmp_path_factory):
    cases = []
    for shape, bits, seed in PSUM_SHAPES:
        rng = np.random.default_rng(seed)
        # shards of different magnitudes, so the scales' max matters
        x = (rng.normal(size=shape) * (10.0 ** np.arange(4) / 10).reshape((4,) + (1,) * (len(shape) - 1)))
        cases.append((x.astype(np.float32), bits))
    init = str(tmp_path_factory.mktemp("gloo") / "rendezvous")
    return cases, run_ranks(4, init, cases, timeout_s=60.0)


@pytest.mark.parametrize("case", range(len(PSUM_SHAPES)))
def test_compressed_psum_four_ranks_matches_jax_vmap(psum_ranks, case):
    cases, out = psum_ranks
    x, bits = cases[case]
    want = np.asarray(jax.vmap(lambda v: jc.compressed_psum(v, "dp", bits=bits),
                               axis_name="dp")(jnp.asarray(x)))
    for rank in range(4):
        assert np.array_equal(out[rank][case], want[rank]), rank
    # the mean, to the common scale's quantization error
    gmax = np.abs(x).max()
    assert np.abs(out[0][case] - x.mean(0)).max() <= gmax / ((1 << (bits - 1)) - 1) * 1.01


def test_compressed_psum_one_rank_round_trip(tmp_path):
    """A one-rank group returns ``dequantize(*quantize(x))`` exactly, so
    the identity to quantization error, as JAX's 1-wide ``shard_map``."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(128,))).float()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        out = compressed_psum(x, bits=8)
    finally:
        dist.destroy_process_group()
    assert torch.equal(out, dequantize(*quantize(x, 8)))
    assert float((out - x).abs().max()) <= float(x.abs().max()) / 127 * 1.01


def test_compressed_psum_without_a_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        compressed_psum(torch.ones(4))


# ------------------------------------------------ the compressed step
class _Recording(EFCompressor):
    """The port's compressor, keeping each leaf's codes, scale and
    ``e = grad + residual`` (the step calls it one leaf at a time)."""

    def __init__(self, bits):
        super().__init__(bits)
        self.seen = []

    def compress(self, grads, residual):
        (codes, scales), new_res = super().compress(grads, residual)
        e = grads[0].float() + residual[0]
        self.seen.append((codes[0].clone(), scales[0].clone(), e))
        return (codes, scales), new_res


class _JaxRecording(jc.EFCompressor):
    """JAX's compressor, sending its codes, scales and ``e`` out of the
    jitted step through ``jax.debug.callback``."""

    def __init__(self, bits):
        super().__init__(bits)
        self.seen = []

    def compress(self, grads, residual):
        (codes, scales), new_res = super().compress(grads, residual)
        e = jax.tree_util.tree_map(lambda g, r: g.astype(jnp.float32) + r, grads, residual)
        jax.debug.callback(lambda *a: self.seen.append([[np.asarray(y) for y in x] for x in a]),
                           jax.tree_util.tree_leaves(codes), jax.tree_util.tree_leaves(scales),
                           jax.tree_util.tree_leaves(e))
        return (codes, scales), new_res


@pytest.fixture(scope="module")
def step_pair():
    jcfg = jax_smoke().replace(dtype="float32", vocab_size=VOCAB)
    tcfg = torch_smoke().replace(dtype="float32", vocab_size=VOCAB)
    return jcfg, tcfg, jm.init_params(jcfg, jax.random.PRNGKey(0))


def _load_state(state, jstate):
    """The port's state := JAX's (params, moments, count, residual)."""
    for key, tree in (("params", jstate["params"]), ("ef_residual", jstate["ef_residual"])):
        for d, s in zip(tree_leaves(state[key]), tree_leaves(params_from_jax(_np(tree)))):
            d.copy_(s)
    for key in ("mu", "nu"):
        for d, s in zip(tree_leaves(state["opt"][key]),
                        tree_leaves(params_from_jax(_np(jstate["opt"][key])))):
            d.copy_(s)
    state["opt"]["count"].fill_(int(jstate["opt"]["count"]))
    state["step"].fill_(int(jstate["step"]))


def test_compressed_train_step_matches_jax(step_pair):
    jcfg, tcfg, jparams = step_pair
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2)
    jo = jopt.AdamW(jopt.AdamWConfig(lr=3e-3, warmup_steps=2))
    jcomp = _JaxRecording(8)
    jstate = {"params": jparams, "opt": jo.init(jparams), "step": jnp.zeros((), jnp.int32),
              "ef_residual": jcomp.init(jparams)}
    jstep = jax.jit(jax_train_step(jcfg, jo, compressor=jcomp))
    to, comp = AdamW(opt_cfg), _Recording(8)
    state = init_train_state(tcfg, torch.Generator().manual_seed(0), to, "cpu", compressor=comp)
    assert set(state) == set(jstate)
    step = make_train_step(tcfg, to, compressor=comp)
    rng = np.random.default_rng(3)
    flips = 0
    for k in range(1, 4):
        toks = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
        labels = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
        _load_state(state, jstate)
        mu0 = [m.clone() for m in tree_leaves(state["opt"]["mu"])]
        comp.seen.clear()
        jcomp.seen.clear()
        jstate, jout = jstep(jstate, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        jax.effects_barrier()
        state, out = step(state, {"tokens": _t(toks), "labels": _t(labels)})
        assert int(state["step"]) == int(jstate["step"]) == k
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-5)
        (jcodes, jscales, je), = jcomp.seen
        assert len(comp.seen) == len(jcodes)
        got = zip(comp.seen, jcodes, jscales, je, tree_leaves(state["ef_residual"]),
                  jax.tree_util.tree_leaves(jstate["ef_residual"]))
        sent = []
        for (c, s, e), jcd, js, jee, r, jr in got:
            tol = 1e-4 * float(np.abs(jee).max())
            np.testing.assert_allclose(e.numpy(), jee, rtol=0, atol=tol)
            np.testing.assert_allclose(float(s), float(js), rtol=1e-4)
            dc = c.numpy().astype(np.int32) - jcd.astype(np.int32)
            assert np.abs(dc).max(initial=0) <= 1
            # a code differs only where e sits on a rounding boundary
            # within the tolerance: |residual| near half a scale unit
            jr = np.asarray(jr)
            edge = np.abs(jr[dc != 0]) >= (0.5 - 0.03) * float(js)
            assert edge.all(), (int((~edge).sum()), int((dc != 0).sum()))
            flips += int((dc != 0).sum())
            # the residual carries e minus what was sent, on both sides
            np.testing.assert_allclose(r.numpy(), jr - dc * float(js), rtol=0, atol=2 * tol)
            sent.append((dequantize(c, s).numpy(), jc.dequantize(jcd, js)))
        _assert_step_close(state, jstate, mu0, sent, float(jout["lr"]), opt_cfg, k)
    assert flips < 1e-3 * sum(x.numel() for x in tree_leaves(state["params"])) * 3


def _assert_step_close(state, jstate, mu0, sent, lr, c, k):
    """The step-parity check of ``tests/test_torch_train.py`` at step
    ``k``: first moments to 1e-4 of each leaf's largest entry plus the
    flipped codes' share, (1 - b1)·|sent - jsent|; each weight to what
    Adam's step lr·m̂/(sqrt(v̂) + eps) makes of the two sides' moments
    + 1e-6 + 1e-5·|p|."""
    want = [[np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
            for t in (jstate["params"], jstate["opt"]["mu"], jstate["opt"]["nu"])]
    got = [[x.numpy() for x in tree_leaves(t)]
           for t in (state["params"], state["opt"]["mu"], state["opt"]["nu"])]
    bc1, bc2 = 1 - c.b1 ** k, 1 - c.b2 ** k
    for p, m, v, jp, jmu, jnu, m0, (s, js) in zip(*got, *want, mu0, sent):
        assert np.all(np.abs(m - jmu) <= 1e-4 * np.abs(jmu - c.b1 * m0.numpy()).max()
                      + (1 - c.b1) * np.abs(s - js) + 1e-12)
        step = (m / bc1) / (np.sqrt(v / bc2) + c.eps)
        jstep = (jmu / bc1) / (np.sqrt(jnu / bc2) + c.eps)
        allowed = lr * np.abs(step - jstep) + 1e-6 + 1e-5 * np.abs(jp)
        assert (np.abs(p - jp) <= allowed).all()
