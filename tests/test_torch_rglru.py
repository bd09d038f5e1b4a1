"""The port's RG-LRU path against the JAX package, on the CPU.

K5 (``ops.rglru_scan`` / ``ops.rglru_scan_bwd`` / ``ops.RGLRUScan``, their
plain versions here) against ``rglru_scan_ref``, the Pallas kernel in
interpret mode at several ``block_t``, the layer's ``associative_scan`` and
``jax.vjp`` of ``rglru_scan_ref``: 1e-5 (``tests/test_kernels.py``'s
tolerance for the scan).  ``apply_rglru`` and ``local_attention`` (both
branches) against the JAX layers in float32, outputs and gradients, with
the JAX parameters carried across: 1e-5 relative to each tensor's largest
entry (float32 sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers import attention as jattn
from repro.layers import rglru as jrglru
from repro_torch.kernels import ops, ref
from repro_torch.layers import attention as tattn
from repro_torch.layers import rglru as trglru
from repro_torch.models.weights import params_from_jax

TOL = 1e-5
SHAPES = [(2, 128, 128), (1, 64, 512), (3, 37, 40), (2, 1, 8)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.6, 0.999, size=shape).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    return a, x


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _assoc(a, x):
    def combine(lhs, rhs):
        a1, b1 = lhs
        a2, b2 = rhs
        return a1 * a2, a2 * b1 + b2

    return jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(x)), axis=1)[1]


# ------------------------------------------------------------------- K5


@pytest.mark.parametrize("shape", SHAPES)
def test_scan_forward_matches_jax(shape):
    a, x = _inputs(shape, sum(shape))
    h = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(x))
    assert h.dtype == torch.float32 and h.shape == shape
    _close(h, jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(x)))
    _close(h, _assoc(a, x))


@pytest.mark.parametrize("block_t", [8, 32, 128])
def test_scan_forward_matches_pallas_interpret(block_t):
    a, x = _inputs((2, 128, 256), block_t)
    want = jops.rglru_scan(jnp.asarray(a), jnp.asarray(x), block_b=2, block_t=block_t,
                           block_w=128, interpret=True)
    _close(ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(x)), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_scan_backward_matches_jax_vjp(shape):
    a, x = _inputs(shape, 7 + sum(shape))
    dh = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    h, vjp = jax.vjp(jref.rglru_scan_ref, jnp.asarray(a), jnp.asarray(x))
    da_want, dx_want = vjp(jnp.asarray(dh))
    ta = torch.from_numpy(a).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    th = ops.RGLRUScan.apply(ta, tx)
    th.backward(torch.from_numpy(dh))
    _close(th, h)
    _close(tx.grad, dx_want)
    _close(ta.grad, da_want)
    dx, da = ops.rglru_scan_bwd(ta.detach(), th.detach(), torch.from_numpy(dh))
    assert torch.equal(dx, tx.grad) and torch.equal(da, ta.grad)


def test_plain_scans_step_mul_then_add():
    """The plain versions round each step as one f32 multiply, then one f32
    add (the CUDA kernel's __fmul_rn/__fadd_rn): bit-exact against numpy
    doing the same, both directions."""
    a, x = _inputs((2, 50, 24), 11)
    dh = np.random.default_rng(12).normal(size=a.shape).astype(np.float32)
    h = np.zeros_like(x)
    carry = np.zeros_like(x[:, 0])
    for t in range(x.shape[1]):
        carry = (a[:, t] * carry).astype(np.float32) + x[:, t]
        h[:, t] = carry
    dx, da = np.zeros_like(x), np.zeros_like(x)
    g = np.zeros_like(x[:, 0])
    for t in reversed(range(x.shape[1])):
        a_next = a[:, t + 1] if t + 1 < x.shape[1] else np.zeros_like(g)
        g = dh[:, t] + (a_next * g).astype(np.float32)
        dx[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t else np.zeros_like(g))
    th = ref.rglru_scan(torch.from_numpy(a), torch.from_numpy(x))
    tdx, tda = ref.rglru_scan_bwd(torch.from_numpy(a), th, torch.from_numpy(dh))
    np.testing.assert_array_equal(th.numpy(), h)
    np.testing.assert_array_equal(tdx.numpy(), dx)
    np.testing.assert_array_equal(tda.numpy(), da)


def test_scan_casts_to_f32_and_returns_input_dtypes_in_backward():
    a, x = _inputs((1, 9, 16), 5)
    ta = torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    h = ops.RGLRUScan.apply(ta, tx)
    assert h.dtype == torch.float32
    torch.testing.assert_close(h, ref.rglru_scan(ta.float(), tx.float()), rtol=0, atol=0)
    h.sum().backward()
    assert ta.grad.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16


def test_scan_rejects_mismatched_shapes():
    a, x = (torch.zeros(2, 3, 4), torch.zeros(2, 3, 5))
    with pytest.raises(ValueError, match="shape"):
        ops.rglru_scan(a, x)
    with pytest.raises(ValueError, match="shape"):
        ops.rglru_scan_bwd(a, a, x)
    # meta inputs (the dry run) give a meta output of the right shape
    h = ops.rglru_scan(a.to("meta"), a.to("meta"))
    assert h.device.type == "meta" and h.shape == a.shape and h.dtype == torch.float32
    with pytest.raises(ValueError, match="no kernel"):
        ops.csr_dot(a[0].int().to("meta"), a[0].to("meta"), a[0, 0].to("meta"))


# ------------------------------------------------------------ RG-LRU layer


@pytest.fixture(scope="module")
def rglru_params():
    jp = jrglru.init_rglru(jax.random.PRNGKey(3), 32, 48, 4, jnp.float32, num_heads=2)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_rglru_matches_jax_with_grads(rglru_params, with_state):
    jp, tp = rglru_params
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 21, 32)).astype(np.float32)
    dy = rng.normal(size=(2, 21, 32)).astype(np.float32)
    h0 = rng.normal(size=(2, 48)).astype(np.float32) if with_state else None
    hist = rng.normal(size=(2, 3, 48)).astype(np.float32) if with_state else None

    def jf(p, xx):
        y, (hl, hs) = jrglru.apply_rglru(
            p, xx, jnp.float32, None if h0 is None else jnp.asarray(h0),
            None if hist is None else jnp.asarray(hist))
        return y, hl, hs

    (jy, jhl, jhs), vjp = jax.vjp(jf, jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(dy), jnp.zeros_like(jhl), jnp.zeros_like(jhs)))

    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty, (thl, ths) = trglru.apply_rglru(
        leaves, tx, torch.float32, None if h0 is None else torch.from_numpy(h0),
        None if hist is None else torch.from_numpy(hist))
    ty.backward(torch.from_numpy(dy))
    _close(ty, jy)
    _close(thl, jhl)
    _close(ths, jhs)
    _close(tx.grad, jgx)
    for k, v in leaves.items():
        _close(v.grad, jgp[k])


def test_apply_rglru_bf16_close_to_jax(rglru_params):
    """bf16 compute (the training path's dtype), f32 gates and scan: the
    frameworks round bf16 products at different points, 3e-2."""
    jp, tp = rglru_params
    x = np.random.default_rng(5).normal(size=(1, 17, 32)).astype(np.float32)
    jy, _ = jrglru.apply_rglru(jp, jnp.asarray(x, jnp.bfloat16), jnp.bfloat16)
    ty, (thl, _) = trglru.apply_rglru(tp, torch.from_numpy(x).bfloat16(), torch.bfloat16)
    assert ty.dtype == torch.bfloat16 and thl.dtype == torch.float32
    _close(ty, np.asarray(jy, np.float32), 3e-2)


# ------------------------------------------------------------ local attention


@pytest.mark.parametrize("s,window", [(12, 16), (16, 16), (32, 16), (48, 8)])
def test_local_attention_matches_jax_with_grads(s, window):
    """s <= window: the masked sdpa; s > window: the chunked path (chunk 0
    masks its padding predecessor)."""
    rng = np.random.default_rng(s + window)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    do = rng.normal(size=q.shape).astype(np.float32)
    jo, vjp = jax.vjp(lambda a, b, c: jattn.local_attention(a, b, c, window),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    to = tattn.local_attention(*ts, window)
    to.backward(torch.from_numpy(do))
    _close(to, jo)
    for t, jg in zip(ts, jgrads):
        _close(t.grad, jg)


def test_local_attention_needs_whole_windows():
    q = torch.zeros(1, 24, 2, 8)
    with pytest.raises(AssertionError, match="multiple of window"):
        tattn.local_attention(q, q, q, 16)
