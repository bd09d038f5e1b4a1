"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import no JAX, so they run where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances for attention are those of ``tests/test_kernels.py``: 2e-5
in f32, 2e-2 in bf16.  ``csr_dot`` is bit-exact against ``ref.csr_dot``,
which sums in the kernel's order; both gathers copy bytes and are
bit-exact against ``ref.batch_gather``.  The scan (``rglru_scan`` and its
backward ``rglru_scan_bwd``) is bit-exact against ``ref.rglru_scan`` /
``ref.rglru_scan_bwd``, which step through time as the kernel does.
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


# (n, d, b, rows_per_block, rows_per_step, offset rows): the DNN path's
# feature and label tables (ragged last batch of 60), page blocks, blocks
# of several 16 KB ring chunks, widths that leave 4- or 2-byte words, and
# a table that starts `off` rows into its storage, off a 16-byte boundary
GATHER_CASES = [
    (1_281_160, 32, 100, 1, 8, 0), (1_281_160, 1, 60, 1, 8, 0), (4096, 512, 1001, 8, 16, 0),
    (4096, 512, 37, 2, 1, 0), (256, 4100, 9, 2, 3, 0), (256, 4099, 9, 1, 8, 0),
    (512, 3, 77, 1, 8, 1), (512, 42, 33, 4, 16, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("n,d,b,r,m,off", GATHER_CASES)
def test_batch_gather_kernels_on_card_bit_exact(cuda, n, d, b, r, m, off, dt):
    """Both gathers against ref.batch_gather, with duplicate ids and ids
    outside the table; one launch each per non-empty call, none for B = 0."""
    g = torch.Generator(device=cuda).manual_seed(n + d + b)
    full = torch.randint(-2**31, 2**31 - 1, (n + off, d), generator=g, device=cuda,
                         dtype=torch.int32)
    if dt != torch.int32:
        full = torch.randn(n + off, d, generator=g, device=cuda).to(dt)
    table = full[off:]
    nb = n // r
    idx = torch.randint(-nb - 3, nb + 4, (b,), generator=g, device=cuda, dtype=torch.int32)
    idx[:3] = idx[3]
    want = ref.batch_gather(table, idx, r)
    before = dict(ops.LAUNCHES)
    # block_d = d: some widths are no multiple of the default 512
    got = ops.batch_gather(table, idx, block_d=d, rows_per_block=r)
    got_dma = ops.batch_gather_dma(table, idx, block_d=d, rows_per_block=r, rows_per_step=m)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_dma, want)
    assert ops.LAUNCHES["batch_gather"] == before["batch_gather"] + 1
    assert ops.LAUNCHES["batch_gather_dma"] == before["batch_gather_dma"] + 1
    for fn in (ops.batch_gather, ops.batch_gather_dma):
        assert tuple(fn(table, idx[:0], block_d=d, rows_per_block=r).shape) == (0, d)
    assert ops.LAUNCHES["batch_gather"] == before["batch_gather"] + 1
    assert ops.LAUNCHES["batch_gather_dma"] == before["batch_gather_dma"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,w", [(1, 4096, 2560), (3, 1000, 2560 + 96), (2, 1, 40), (1, 33, 1)])
def test_rglru_scan_kernels_on_card_bit_exact(cuda, b, t, w):
    """Forward and reverse against the plain versions, bit for bit, at the
    training path's shape, a ragged one and T = 1; through ops.RGLRUScan,
    one launch of each per step of autograd."""
    g = torch.Generator(device=cuda).manual_seed(b + t + w)
    a = torch.rand(b, t, w, generator=g, device=cuda) * 0.4 + 0.6
    x = torch.randn(b, t, w, generator=g, device=cuda)
    dh = torch.randn(b, t, w, generator=g, device=cuda)
    before = dict(ops.LAUNCHES)
    h = ops.rglru_scan(a, x)
    dx, da = ops.rglru_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    want_h = ref.rglru_scan(a, x)
    want_dx, want_da = ref.rglru_scan_bwd(a, want_h, dh)
    assert torch.equal(h, want_h) and torch.equal(dx, want_dx) and torch.equal(da, want_da)
    assert ops.LAUNCHES["rglru_scan"] == before["rglru_scan"] + 1
    assert ops.LAUNCHES["rglru_scan_bwd"] == before["rglru_scan_bwd"] + 1
    ta, tx = a.clone().requires_grad_(), x.clone().requires_grad_()
    ops.RGLRUScan.apply(ta, tx).backward(dh)
    assert torch.equal(tx.grad, dx) and torch.equal(ta.grad, da)
    assert ops.LAUNCHES["rglru_scan"] == before["rglru_scan"] + 2
    assert ops.LAUNCHES["rglru_scan_bwd"] == before["rglru_scan_bwd"] + 2
