"""The port's attention kernels against the JAX package, and the
wrappers' dispatch (``csr_dot`` is held against JAX in ``test_torch_svm.py``).

On the CPU the port's wrappers run their plain versions; those are held
against the Pallas kernels (interpret mode, as ``tests/test_kernels.py``
runs them) where the Pallas kernels take the shape, and against the JAX
layer functions everywhere, including ragged S/T (which the Pallas
kernels assert away) and decode rows with ``cur >= T``.  Tolerances are
those of ``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16.  The CUDA
kernels themselves are tested in ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.layers import attention as jattn
from repro_torch.kernels import ops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor."""
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, dtype=dtype), torch.from_numpy(x).to(TORCH_DT[dtype])


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


# --------------------------------------------------------- flash_attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "h,kh,causal", [(2, 2, True), (4, 2, False), (8, 2, True)]  # groups 1, 2, 4
)
def test_flash_attention_matches_pallas_kernel(h, kh, causal, dtype):
    rng = np.random.default_rng(h * 10 + kh + causal)
    qj, q = _pair(rng, (2, 64, h, 32), dtype)
    kj, k = _pair(rng, (2, 64, kh, 32), dtype)
    vj, v = _pair(rng, (2, 64, kh, 32), dtype)
    want = jops.flash_attention(qj, kj, vj, causal=causal, block_q=32, block_k=32)
    _close(ops.flash_attention(q, k, v, causal=causal), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,s", [(2, 2, 1), (4, 2, 37), (8, 2, 100)])
def test_flash_attention_ragged_matches_layer(h, kh, s, dtype):
    """Ragged S (any prompt capacity): against full_attention and, for the
    non-causal case, sdpa — the functions the JAX serve path calls."""
    rng = np.random.default_rng(s + h)
    qj, q = _pair(rng, (1, s, h, 16), dtype)
    kj, k = _pair(rng, (1, s, kh, 16), dtype)
    vj, v = _pair(rng, (1, s, kh, 16), dtype)
    _close(ops.flash_attention(q, k, v), jattn.full_attention(qj, kj, vj), dtype)
    _close(ops.flash_attention(q, k, v, causal=False), jattn.sdpa(qj, kj, vj), dtype)


# ------------------------------------------------------------ flash_decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh", [(2, 2), (4, 2), (8, 2)])
def test_flash_decode_matches_pallas_kernel(h, kh, dtype):
    rng = np.random.default_rng(h + kh)
    t = 128
    qj, q = _pair(rng, (4, h, 32), dtype)
    kj, k = _pair(rng, (4, t, kh, 32), dtype)
    vj, v = _pair(rng, (4, t, kh, 32), dtype)
    cur = np.asarray([0, 31, 77, t + 9], np.int32)  # the last row: cur >= T
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(cur), block_k=32)
    _close(ops.flash_decode(q, k, v, torch.from_numpy(cur)), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,t", [(2, 2, 1), (4, 2, 45), (8, 2, 130)])
def test_flash_decode_ragged_matches_layer(h, kh, t, dtype):
    """Arbitrary arena length T and rows past its end (idle slots keep
    advancing): against decode_attention."""
    rng = np.random.default_rng(t * 3 + h)
    qj, q = _pair(rng, (5, h, 16), dtype)
    kj, k = _pair(rng, (5, t, kh, 16), dtype)
    vj, v = _pair(rng, (5, t, kh, 16), dtype)
    cur = np.asarray([0, t // 2, t - 1, t, t + 40], np.int32)
    want = jattn.decode_attention(qj[:, None], kj, vj, jnp.asarray(cur))[:, 0]
    _close(ops.flash_decode(q, k, v, torch.from_numpy(cur)), want, dtype)


def test_flash_decode_ignores_entries_past_cur():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 50, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 50, 2, 16)).astype(np.float32))
    cur = torch.tensor([20], dtype=torch.int32)
    a = ops.flash_decode(q, k, v, cur)
    k2, v2 = k.clone(), v.clone()
    k2[:, 21:] = 999.0
    v2[:, 21:] = -999.0
    torch.testing.assert_close(ops.flash_decode(q, k2, v2, cur), a, rtol=0, atol=0)


# ----------------------------------------------------------------- dispatch


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    ops.reset_launch_counts()
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 4, 1, 16)
    ops.flash_attention(q, k, k)
    ops.flash_decode(q[:, 0], k, k, torch.zeros(1, dtype=torch.int32))
    idx, val, w = torch.zeros(3, 8, dtype=torch.int32), torch.ones(3, 8), torch.ones(5)
    ops.csr_dot(idx, val, w)
    ops.batch_gather(val, idx[0])
    ops.batch_gather_dma(val, idx[0])
    a = torch.rand(2, 5, 3, requires_grad=True)
    ops.RGLRUScan.apply(a, a).sum().backward()
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_decode": 0, "csr_dot": 0,
                            "batch_gather": 0, "batch_gather_dma": 0,
                            "rglru_scan": 0, "rglru_scan_bwd": 0}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.batch_gather(val.to("meta"), idx[0].to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.csr_dot(idx.to("meta"), val.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention(q, k.to("meta"), k)
