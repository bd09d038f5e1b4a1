"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import no JAX, so they run where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances for attention are those of ``tests/test_kernels.py``: 2e-5
in f32, 2e-2 in bf16.  ``csr_dot`` is bit-exact against ``ref.csr_dot``,
which sums in the kernel's order.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("s,h,kh,d", [(128, 32, 8, 128), (200, 32, 8, 128), (37, 4, 1, 64)])
def test_flash_attention_kernel_on_card(cuda, s, h, kh, d, dt):
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(1, s, n, d, generator=g).to(cuda, dt) for n in (h, kh, kh))
    before = ops.LAUNCHES["flash_attention"]
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])
    assert ops.LAUNCHES["flash_attention"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
def test_flash_decode_kernel_on_card(cuda, dt):
    g = torch.Generator().manual_seed(1)
    c = 160
    q = torch.randn(8, 32, 128, generator=g).to(cuda, dt)
    k, v = (torch.randn(8, c, 8, 128, generator=g).to(cuda, dt) for _ in range(2))
    cur = torch.tensor([0, 5, 31, 32, 100, c - 1, c, c + 50], dtype=torch.int32, device=cuda)
    got = ops.flash_decode(q, k, v, cur)
    want = ref.flash_decode(q, k, v, cur)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.gpu
@pytest.mark.parametrize("gather", ["take", "onehot"])
@pytest.mark.parametrize("b,k,d", [(10_000, 5456, 16_609_143), (1001, 77, 1000), (9, 33, 6), (1, 1, 1)])
def test_csr_dot_kernel_on_card_bit_exact(cuda, b, k, d, gather):
    """Bit-exact against ref.csr_dot (the kernel's summation order), on
    padded rows with duplicate ids; one launch per non-empty call."""
    g = torch.Generator(device=cuda).manual_seed(b + k)
    idx = torch.randint(0, d, (b, k), generator=g, device=cuda, dtype=torch.int32)
    val = torch.randn(b, k, generator=g, device=cuda)
    keep = torch.randint(1, k + 1, (b, 1), generator=g, device=cuda)
    pad = torch.arange(k, device=cuda)[None, :] >= keep
    idx, val = idx.masked_fill(pad, 0), val.masked_fill(pad, 0.0)
    w = torch.randn(d, generator=g, device=cuda)
    before = ops.LAUNCHES["csr_dot"]
    got = ops.csr_dot(idx, val, w, gather=gather)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["csr_dot"] == before + 1
    assert torch.equal(got, ref.csr_dot(idx, val, w))
    empty = ops.csr_dot(idx[:0], val[:0], w)
    assert empty.shape == (0,) and ops.LAUNCHES["csr_dot"] == before + 1
