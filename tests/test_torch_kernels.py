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


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_head_dim_160_matches_pallas_kernel(causal):
    """stablelm-12b's head dim 160 at its group 4 (8 query heads on 2 KV
    heads), f32: the plain version against the Pallas kernel in
    interpret mode, two 64-key blocks."""
    rng = np.random.default_rng(160 + causal)
    qj, q = _pair(rng, (1, 128, 8, 160), "float32")
    kj, k = _pair(rng, (1, 128, 2, 160), "float32")
    vj, v = _pair(rng, (1, 128, 2, 160), "float32")
    want = jops.flash_attention(qj, kj, vj, causal=causal, block_q=64, block_k=64,
                                interpret=True)
    _close(ops.flash_attention(q, k, v, causal=causal), want, "float32")


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_every_cur_matches_pallas_kernel(dtype):
    """One batch row per cur in 0..T+2 (every position, the last, and past
    the arena): the plain decode against the Pallas kernel in interpret
    mode, two 16-key blocks."""
    t = 32
    rng = np.random.default_rng(t)
    b = t + 3
    qj, q = _pair(rng, (b, 4, 32), dtype)
    kj, k = _pair(rng, (b, t, 1, 32), dtype)
    vj, v = _pair(rng, (b, t, 1, 32), dtype)
    cur = np.arange(b, dtype=np.int32)
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(cur), block_k=16, interpret=True)
    _close(ops.flash_decode(q, k, v, torch.from_numpy(cur)), want, dtype)


def test_flash_decode_at_head_dim_160_matches_pallas_kernel():
    """stablelm-12b's head dim 160 at group 4, f32, one row each with cur
    inside the cache, at T-1 and past T: the plain version against the
    Pallas kernel in interpret mode, two 64-key blocks."""
    t = 128
    rng = np.random.default_rng(t + 160)
    qj, q = _pair(rng, (4, 8, 160), "float32")
    kj, k = _pair(rng, (4, t, 2, 160), "float32")
    vj, v = _pair(rng, (4, t, 2, 160), "float32")
    cur = np.asarray([0, 70, t - 1, t + 5], np.int32)
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(cur), block_k=64, interpret=True)
    _close(ops.flash_decode(q, k, v, torch.from_numpy(cur)), want, "float32")


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
    b = torch.rand(1, 4, 2, 16, requires_grad=True)
    ops.CausalAttention.apply(b, k, k).sum().backward()
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_decode": 0, "csr_dot": 0,
                            "batch_gather": 0, "batch_gather_dma": 0,
                            "rglru_scan": 0, "rglru_scan_bwd": 0,
                            "flash_attention_train": 0, "flash_attention_bwd": 0}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.batch_gather(val.to("meta"), idx[0].to("meta"))
    # K4, K5 and K6 give meta outputs of the right shape on meta inputs
    # (the dry run), computing and launching nothing
    out = ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    out = ops.flash_decode(q[:, 0].to("meta"), k.to("meta"), k.to("meta"),
                           torch.zeros(1, dtype=torch.int32, device="meta"))
    assert out.device.type == "meta" and out.shape == q[:, 0].shape
    h = ops.rglru_scan(a.detach().to("meta"), a.detach().to("meta"))
    assert h.device.type == "meta" and h.shape == a.shape and h.dtype == torch.float32
    assert sum(ops.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.csr_dot(idx.to("meta"), val.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention_train(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention(q, k.to("meta"), k)


@pytest.mark.parametrize("dtype,d,group,kernel", [
    (torch.bfloat16, 128, 4, "wgmma"),   # granite-3-8b's prefill
    (torch.bfloat16, 160, 4, "wgmma"),   # stablelm-12b's prefill
    (torch.bfloat16, 160, 3, "cuda_core"),
    (torch.float32, 160, 4, "cuda_core"),
    (torch.bfloat16, 64, 1, "wgmma"),
    (torch.bfloat16, 128, 64, "wgmma"),  # one position a 64-row tile
    (torch.bfloat16, 128, 3, "cuda_core"),  # 3 does not divide 64
    (torch.bfloat16, 128, 128, "cuda_core"),
    (torch.bfloat16, 32, 4, "cuda_core"),
    (torch.bfloat16, 96, 2, "cuda_core"),
    (torch.float32, 128, 4, "cuda_core"),  # TF32 would miss f32's tolerance
    (torch.float32, 64, 1, "cuda_core"),
])
def test_attention_kernel_routing(dtype, d, group, kernel):
    assert ops._attention_kernel(dtype, d, group) == kernel


def test_check_cuda_rejects_what_the_attention_kernels_do_not_take():
    """The checks a CUDA call passes before either attention kernel is
    chosen: dtype, contiguity, 16-byte alignment, grouping, head dim."""
    q = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    assert ops._check_cuda("fa", (q, k, k), 8, 2, 64) == 1
    assert ops._check_cuda("fa", (q.float(), k.float(), k.float()), 8, 2, 64) == 0
    with pytest.raises(TypeError, match="one dtype"):
        ops._check_cuda("fa", (q.half(), k.half(), k.half()), 8, 2, 64)
    with pytest.raises(TypeError, match="one dtype"):
        ops._check_cuda("fa", (q, k.float(), k), 8, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_cuda("fa", (q.transpose(1, 2), k, k), 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._check_cuda("fa", (q.view(-1)[1:].view(1, 1, 1, -1)[..., :64], k, k), 8, 2, 64)
    with pytest.raises(ValueError, match="do not group"):
        ops._check_cuda("fa", (q, k, k), 8, 3, 64)
    with pytest.raises(ValueError, match="head dim"):
        ops._check_cuda("fa", (q[..., :60].contiguous(), k, k), 8, 2, 60)
    for d in (160, 168, 192):  # past stablelm-12b's 160, no route takes a head dim
        qd = torch.zeros(1, 4, 8, d, dtype=torch.bfloat16)
        if d == 160:
            assert ops._check_cuda("fa", (qd, qd, qd), 8, 2, d) == 1
            continue
        with pytest.raises(ValueError, match=f"head dim {d} .*8..160"):
            ops._check_cuda("fa", (qd, qd, qd), 8, 2, d)


@pytest.mark.parametrize("call,error", [
    (lambda: ops.flash_attention(torch.zeros(4, 2, 16), torch.zeros(1, 4, 1, 16),
                                 torch.zeros(1, 4, 1, 16)), "shapes"),
    (lambda: ops.flash_attention(torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 1, 16),
                                 torch.zeros(1, 5, 1, 16)), "shapes"),
    (lambda: ops.flash_attention(torch.zeros(2, 4, 2, 16), torch.zeros(1, 4, 1, 16),
                                 torch.zeros(1, 4, 1, 16)), "vs k"),
    (lambda: ops.batch_gather_dma(torch.zeros(8, 4), torch.zeros(2, dtype=torch.int32),
                                  rows_per_step=0), "rows_per_step"),
    (lambda: ops.batch_gather_dma(torch.zeros(9, 4), torch.zeros(2, dtype=torch.int32),
                                  rows_per_block=2), "blocks of 2"),
    (lambda: ops.batch_gather_dma(torch.zeros(8, 4), torch.zeros(2)), "integers"),
    (lambda: ops.batch_gather_dma(torch.zeros(8, 4, dtype=torch.float64),
                                  torch.zeros(2, dtype=torch.int32)), "float32/bfloat16/int32"),
])
def test_wrapper_argument_checks(call, error):
    with pytest.raises((ValueError, TypeError), match=error):
        call()


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 128, "cluster"),  # granite-3-8b's decode
    (torch.bfloat16, 160, "cluster"),  # stablelm-12b's decode
    (torch.float32, 160, "tile"),
    (torch.bfloat16, 64, "cluster"),
    (torch.bfloat16, 256, "cluster"),  # recurrentgemma-2b's local-attention decode
    (torch.float32, 256, "tile"),      # which refuses it (below)
    (torch.bfloat16, 96, "tile"),
    (torch.bfloat16, 32, "tile"),
    (torch.float32, 128, "tile"),
    (torch.float32, 64, "tile"),
])
def test_decode_kernel_routing(dtype, d, kernel):
    assert ops._decode_kernel(dtype, d) == kernel


def test_head_dim_256_only_on_the_cluster_route():
    """bf16 decode at D 256 passes the checks at the cluster kernel's limit;
    f32 decode (the tile kernel) and K4 stop at 128, with a message that
    names the route that takes 256."""
    q = torch.zeros(4, 10, 256, dtype=torch.bfloat16)
    kc = torch.zeros(4, 64, 1, 256, dtype=torch.bfloat16)
    assert ops._check_cuda("flash_decode", (q, kc, kc), 10, 1, 256, max_head_dim=256) == 1
    for name, dt in (("flash_decode", torch.float32), ("flash_attention", torch.bfloat16)):
        with pytest.raises(ValueError, match="head dim 256 .*cluster kernel"):
            ops._check_cuda(name, (q.to(dt), kc.to(dt), kc.to(dt)), 10, 1, 256)
    assert ops._attention_kernel(torch.bfloat16, 256, 10) == "cuda_core"


@pytest.mark.parametrize("b,kh,t,sms,want", [
    (8, 8, 160, 132, (3, 64)),    # the serving shape: 192 blocks, one tile each
    (1, 8, 160, 132, (3, 64)),    # B = 1: as many splits as tiles
    (8, 8, 4096, 132, (8, 512)),  # long context: at most 8 tiles a block
    (64, 8, 160, 132, (1, 192)),  # enough rows to cover the SMs unsplit
    (8, 8, 33, 132, (1, 64)),     # one tile
    (1, 1, 1, 132, (1, 64)),
    (8, 8, 1024, 132, (3, 384)),
])
def test_decode_splits(b, kh, t, sms, want):
    assert ops._decode_splits(b, kh, t, sms) == want


@pytest.mark.parametrize("b,kh", [(1, 1), (1, 8), (8, 8), (3, 2), (200, 8)])
@pytest.mark.parametrize("t", [1, 32, 33, 64, 65, 160, 511, 4096, 100_000])
def test_decode_splits_cover_the_cache(b, kh, t):
    """Every split is whole 64-key tiles, the slices cover T and none lies
    wholly past it, at most 8 (the cluster's limit) and at most one a tile,
    and no block walks more than 8 tiles unless 8 splits cannot cover T so."""
    splits, chunk = ops._decode_splits(b, kh, t, 132)
    tiles = -(-t // 64)
    assert 1 <= splits <= min(8, tiles) and chunk % 64 == 0
    assert (splits - 1) * chunk < t <= splits * chunk
    assert chunk // 64 <= max(8, -(-tiles // 8))


def test_scan_kernel_routing():
    """The ring kernel where a tensor map describes every operand (W % 4 ==
    0, 16-byte aligned); the lanes kernel otherwise (W 1, 40-wide rows off
    a 16-byte boundary, W % 4 != 0)."""
    a = torch.zeros(2, 5, 40)
    assert ops._scan_kernel(a, torch.zeros_like(a)) == "ring"
    assert ops._scan_kernel(torch.zeros(1, 33, 1), torch.zeros(1, 33, 1)) == "lanes"
    assert ops._scan_kernel(torch.zeros(2, 77, 2562), torch.zeros(2, 77, 2562)) == "lanes"
    shifted = torch.zeros(2 * 5 * 40 + 1)[1:].view(2, 5, 40)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert ops._scan_kernel(a, shifted) == "lanes"


def test_reset_clears_launches_by_entry_point():
    ops.ENTRY_LAUNCHES["repro_torch_flash_decode_cluster"] = 3
    ops.reset_launch_counts()
    assert ops.ENTRY_LAUNCHES == {} and set(ops.LAUNCHES.values()) == {0}


# ------------------------------------------- the training path's attention
# ``ops.CausalAttention`` on the card; here its plain versions
# (``ref.flash_attention_lse``, ``ref.flash_attention_bwd``) and the route.


def _causal_grads(q, k, v, do):
    """The masked ``sdpa``'s output and its autograd gradients."""
    from repro_torch.layers.attention import causal_mask
    from repro_torch.layers.sdpa import sdpa

    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = sdpa(*xs, mask=causal_mask(q.shape[1], k.shape[1]))
    return (o.detach(), *torch.autograd.grad(o, xs, do))


# (S, H, K, D, key block): one block, ragged last blocks, groups 1, 2, 4, 8
TRAIN_ATTN_CASES = [(16, 4, 4, 16, 64), (65, 8, 2, 16, 64), (100, 8, 1, 32, 64),
                    (130, 8, 8, 16, 64), (77, 16, 2, 8, 16)]


@pytest.mark.parametrize("s,h,kh,d,block", TRAIN_ATTN_CASES)
def test_flash_attention_bwd_plain_matches_sdpa_autograd(s, h, kh, d, block):
    """The backward's arithmetic (Δ, the weights recomputed from lse a key
    block at a time) against autograd of the masked ``sdpa``, in f32,
    where the roundings to q's dtype are no-ops: within f32's 2e-5."""
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(s * 7 + h)
    q = torch.randn(2, s, h, d, generator=g)
    k, v = (torch.randn(2, s, kh, d, generator=g) for _ in range(2))
    do = torch.randn(2, s, h, d, generator=g)
    o, dq, dk, dv = _causal_grads(q, k, v, do)
    got_o, lse = ref.flash_attention_lse(q, k, v)
    torch.testing.assert_close(got_o, o, rtol=2e-5, atol=2e-5)
    for got, want in zip(ref.flash_attention_bwd(q, k, v, got_o, lse, do, block), (dq, dk, dv)):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,h,kh,d", [(1, 2, 1, 16), (40, 4, 2, 16), (70, 8, 4, 32)])
def test_flash_attention_lse_is_the_rows_log_sum_exp(s, h, kh, d):
    """lse (B,H,S): each row's log-sum-exp of its scaled f32 scores over
    the keys at or before it."""
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(s + d)
    q = torch.randn(1, s, h, d, generator=g)
    k, v = (torch.randn(1, s, kh, d, generator=g) for _ in range(2))
    _, lse = ref.flash_attention_lse(q, k, v)
    assert lse.shape == (1, h, s) and lse.dtype == torch.float32
    kx = k.repeat_interleave(h // kh, dim=2)
    sc = torch.einsum("bshd,bthd->bhst", q, kx) / d ** 0.5
    keep = torch.arange(s)[None, :] <= torch.arange(s)[:, None]
    want = torch.logsumexp(torch.where(keep, sc, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_attention_function_on_cpu_matches_sdpa(dtype):
    """``ops.CausalAttention`` on CPU tensors (its plain versions) gives the
    masked ``sdpa``'s output and gradients: in f32 within 2e-5; in bf16
    within 2e-2 (P and dS rounded where the kernels round them, against
    autograd's roundings)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 33, 8, 16, generator=g).to(dtype)
    k, v = (torch.randn(1, 33, 2, 16, generator=g).to(dtype) for _ in range(2))
    do = torch.randn(1, 33, 8, 16, generator=g).to(dtype)
    want = _causal_grads(q, k, v, do)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ops.CausalAttention.apply(*xs)
    got = (o.detach(), *torch.autograd.grad(o, xs, do))
    tol = TOL[str(dtype).removeprefix("torch.")]
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("device,dtype,d,group,s,t,route", [
    ("cuda", torch.bfloat16, 128, 4, 4096, 4096, "fused"),  # granite-3-8b's training
    ("cuda", torch.bfloat16, 64, 1, 65, 65, "fused"),
    ("cuda", torch.bfloat16, 128, 64, 100, 100, "fused"),  # one position a 64-row tile
    ("cuda", torch.bfloat16, 160, 4, 4096, 4096, "plain"),  # stablelm-12b: no backward kernel
    ("cuda", torch.bfloat16, 128, 6, 4096, 4096, "plain"),  # dbrx-132b's group
    ("cuda", torch.bfloat16, 128, 3, 4096, 4096, "plain"),  # phi4-mini-3.8b's
    ("cuda", torch.bfloat16, 128, 128, 100, 100, "plain"),
    ("cuda", torch.bfloat16, 128, 4, 100, 120, "plain"),  # keys past the queries
    ("cuda", torch.float32, 128, 4, 4096, 4096, "plain"),
    ("cpu", torch.bfloat16, 128, 4, 4096, 4096, "plain"),
    ("meta", torch.bfloat16, 128, 4, 4096, 4096, "plain"),
])
def test_train_attention_routing(device, dtype, d, group, s, t, route):
    assert ops._train_attention_kernel(device, dtype, d, group, s, t) == route


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_causal_attention_keeps_the_plain_sdpa_on_cpu_and_meta(device):
    """granite-3-8b's heads in bf16 off the card run the masked ``sdpa``
    (the CPU tests against JAX and the dry run see no change): no
    ``CausalAttention`` node, no launch, and on meta the right shape."""
    from repro_torch.layers import attention

    ops.reset_launch_counts()
    q = torch.randn(1, 8, 32, 128, dtype=torch.bfloat16, device=device, requires_grad=True)
    k = torch.randn(1, 8, 8, 128, dtype=torch.bfloat16, device=device)
    assert ops.train_attention_route(q, k, k) == "plain"
    o = attention.causal_attention(q, k, k, ckpt=True)
    assert o.shape == q.shape and o.device.type == device
    assert "CausalAttention" not in type(o.grad_fn).__name__
    assert sum(ops.LAUNCHES.values()) == 0
