"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import no JAX, so they run where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances for attention are those of ``tests/test_kernels.py``: 2e-5
in f32, 2e-2 in bf16.  bf16 attention with head dim 64, 128 or 160 and a
group dividing 64 runs the tensor-core kernel
(``flash_attention_wgmma.cu``), the rest the CUDA-core one
(``flash_attention.cu``, head dims up to 160); bf16 decode with head dim
64, 128, 160 or 256 runs the split-KV cluster kernel
(``flash_decode_cluster.cu``), f32 decode the tile kernel
(``flash_decode.cu``, head dims up to 160).  Head dim 160 is
stablelm-12b's.  ``csr_dot`` is bit-exact against ``ref.csr_dot``,
which sums in the kernel's order; both gathers copy bytes and are
bit-exact against ``ref.batch_gather``, ``batch_gather`` on both of its
routes (host ids in the launch's parameters, or ids loaded on the card).  The scan (``rglru_scan`` and its
backward ``rglru_scan_bwd``) is bit-exact against ``ref.rglru_scan`` /
``ref.rglru_scan_bwd``, which step through time as the kernels do, on
the TMA ring kernel (W % 4 == 0) and the lanes kernel (the rest).
whisper-tiny's shapes: K4 with ``causal=False`` at its encoder's (8,
1500) and its cross-attention's (8, 384) x 1,500, K6 on its 1,500-frame
cross cache at ``cur`` = T - 1 (cross-attention's), T - 2, 0 and past T,
each on N(0, 1) inputs and on ``ref.edge_probe``'s, on which the same
tolerance fails a planted fault at the ragged last key tile.
Gradient compression (no kernel) gives the CPU's bits on the card.
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
@pytest.mark.parametrize("s,h,kh,d", [(128, 32, 8, 128), (200, 32, 8, 128), (37, 4, 1, 64),
                                     (128, 32, 8, 160), (200, 32, 8, 160), (37, 4, 1, 160)])
def test_flash_attention_kernel_on_card(cuda, s, h, kh, d, dt):
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(1, s, n, d, generator=g).to(cuda, dt) for n in (h, kh, kh))
    before = ops.LAUNCHES["flash_attention"]
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])
    assert ops.LAUNCHES["flash_attention"] == before + 2


# (S, T): one key tile, its edges (63/64/65), several tiles, granite's
# 4,096-token context, and S != T both ways
ATTN_LENGTHS = [(1, 1), (63, 63), (64, 64), (65, 65), (200, 200), (4096, 4096),
                (1, 200), (65, 200), (200, 63), (4096, 65), (63, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 160])
@pytest.mark.parametrize("s,t", ATTN_LENGTHS)
def test_flash_attention_wgmma_on_card(cuda, s, t, d, group):
    """The tensor-core kernel (bf16, D 64/128/160, groups 1/4/8) against the
    plain version, causal and not, at ragged S and T; one launch a call."""
    kh = 2
    assert ops._attention_kernel(torch.bfloat16, d, group) == "wgmma"
    g = torch.Generator().manual_seed(s + t + d + group)
    q = torch.randn(1, s, kh * group, d, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(1, t, kh, d, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    before = ops.LAUNCHES["flash_attention"]
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert ops.LAUNCHES["flash_attention"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("s", [64, 128, 200])
@pytest.mark.parametrize("h,kh", [(16, 16), (24, 8), (48, 8), (32, 8)])
@pytest.mark.parametrize("d", [128, 160])
def test_flash_attention_at_the_copied_configs_heads_on_card(cuda, d, h, kh, s, dt):
    """K4 at the heads of qwen2-moe-a2.7b (16/16, group 1), phi4-mini-3.8b
    (24/8, group 3: bf16 on the CUDA-core kernel, 3 does not divide 64),
    dbrx-132b (48/8, group 6, likewise) and minitron-8b (32/8), D 128;
    and the same groups at D 160, stablelm-12b's (32/8)."""
    route = ops._attention_kernel(dt, d, h // kh)
    assert route == ("wgmma" if dt == torch.bfloat16 and 64 % (h // kh) == 0 else "cuda_core")
    g = torch.Generator().manual_seed(s + h + d)
    q, k, v = (torch.randn(1, s, n, d, generator=g).to(cuda, dt) for n in (h, kh, kh))
    ops.reset_launch_counts()
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])
    entry = "repro_torch_flash_attention" + ("_wgmma" if route == "wgmma" else "")
    assert ops.ENTRY_LAUNCHES == {entry: 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", [128, 160])
def test_flash_decode_kernel_on_card(cuda, d, dt):
    g = torch.Generator().manual_seed(1)
    c = 160
    q = torch.randn(8, 32, d, generator=g).to(cuda, dt)
    k, v = (torch.randn(8, c, 8, d, generator=g).to(cuda, dt) for _ in range(2))
    cur = torch.tensor([0, 5, 31, 32, 100, c - 1, c, c + 50], dtype=torch.int32, device=cuda)
    got = ops.flash_decode(q, k, v, cur)
    want = ref.flash_decode(q, k, v, cur)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])


def _decode_curs(t):
    """cur at 0, at both sides of every 64-key tile edge (every split
    boundary of the cluster kernel is one), T-1, T and past T."""
    edges = [e for c in range(64, t, 64) for e in (c - 1, c)]
    return sorted({0, *edges, t - 1, t, t + 7})


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", [64, 128, 160])
@pytest.mark.parametrize("group", [1, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("t", [1, 32, 33, 160, 4096])
def test_flash_decode_sweep_on_card(cuda, t, group, d, dt):
    """Both decode kernels against the plain version over arena lengths,
    groups (3 and 6: phi4-mini-3.8b's and dbrx-132b's), head dims and cur
    at every split boundary; one launch a call, bf16 on the cluster
    kernel."""
    curs = _decode_curs(t)
    b, kh = len(curs), 2
    g = torch.Generator(device=cuda).manual_seed(t + group + d)
    q = torch.randn(b, kh * group, d, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(b, t, kh, d, generator=g, device=cuda).to(dt) for _ in range(2))
    cur = torch.tensor(curs, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = ops.flash_decode(q, k, v, cur)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.flash_decode(q, k, v, cur).float(),
                               rtol=TOL[dt], atol=TOL[dt])
    entry = {torch.bfloat16: "repro_torch_flash_decode_cluster",
             torch.float32: "repro_torch_flash_decode"}[dt]
    assert ops.LAUNCHES["flash_decode"] == 1 and ops.ENTRY_LAUNCHES == {entry: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("group,kh", [(10, 1), (8, 2)])
@pytest.mark.parametrize("t", [1, 100, 2048, 2049])
def test_flash_decode_head_dim_256_on_card(cuda, t, group, kh):
    """bf16 decode at head dim 256 on the cluster kernel: recurrentgemma-2b's
    ring (MQA, 10 heads on one KV head; T = 2,048) and ragged T, cur at
    every split boundary, T-1, T and past T; one launch a call."""
    curs = _decode_curs(t)
    b, d = len(curs), 256
    g = torch.Generator(device=cuda).manual_seed(t + group)
    q = torch.randn(b, kh * group, d, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(b, t, kh, d, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    cur = torch.tensor(curs, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = ops.flash_decode(q, k, v, cur)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.flash_decode(q, k, v, cur).float(),
                               rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])
    assert ops.ENTRY_LAUNCHES == {"repro_torch_flash_decode_cluster": 1}


@pytest.mark.gpu
def test_flash_decode_head_dim_256_f32_is_refused_on_card(cuda):
    z = torch.zeros(1, 64, 1, 256, device=cuda)
    with pytest.raises(ValueError, match="cluster kernel"):
        ops.flash_decode(torch.zeros(1, 10, 256, device=cuda), z, z,
                         torch.zeros(1, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
def test_head_dims_past_160_are_refused_on_card(cuda, dt):
    """168 has no instantiation on either attention or decode route (the
    cluster kernel's 256 aside): refused before a launch."""
    z = torch.zeros(1, 64, 2, 168, device=cuda, dtype=dt)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="head dim 168"):
        ops.flash_attention(torch.zeros(1, 64, 8, 168, device=cuda, dtype=dt), z, z)
    with pytest.raises(ValueError, match="head dim 168"):
        ops.flash_decode(torch.zeros(1, 8, 168, device=cuda, dtype=dt), z, z,
                         torch.zeros(1, dtype=torch.int32, device=cuda))
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_decode"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("t", [1, 160, 4096])
def test_flash_decode_one_row_on_card(cuda, t, dt):
    """B = 1 at the serving widths (the fewest blocks): every cur value of
    a short arena, the last position of the others."""
    g = torch.Generator(device=cuda).manual_seed(t)
    q = torch.randn(1, 32, 128, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(1, t, 8, 128, generator=g, device=cuda).to(dt) for _ in range(2))
    for c in (range(t + 2) if t <= 160 else (t - 1,)):
        cur = torch.tensor([c], dtype=torch.int32, device=cuda)
        got = ops.flash_decode(q, k, v, cur)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.flash_decode(q, k, v, cur).float(),
                                   rtol=TOL[dt], atol=TOL[dt])


# whisper-tiny's attention (6 heads of 64, group 1): the encoder's
# bidirectional (8, 1500) x (8, 1500), the decoder's cross-attention of 384
# tokens against the 1,500 frames, and one decoder token against them
WHISPER_ATTENTION = [(8, 1500, 1500), (8, 384, 1500), (1, 1, 1500)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,s,t", WHISPER_ATTENTION)
def test_flash_attention_non_causal_at_whisper_shapes_on_card(cuda, b, s, t, dt):
    """K4 with ``causal=False`` at whisper-tiny's encoder and cross shapes
    (T = 1,500 is no whole number of 64-key tiles), bf16 on the
    tensor-core kernel, f32 on the CUDA-core one; one launch a call."""
    route = ops._attention_kernel(dt, 64, 1)
    assert route == ("wgmma" if dt == torch.bfloat16 else "cuda_core")
    g = torch.Generator(device=cuda).manual_seed(b + s + t)
    q = torch.randn(b, s, 6, 64, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(b, t, 6, 64, generator=g, device=cuda).to(dt) for _ in range(2))
    probe = ref.edge_probe((b, s, 6, 64), (b, t, 6, 64), dt, g)
    ops.reset_launch_counts()
    for q, k, v in ((q, k, v), probe):
        got = ops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, causal=False)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])
    entry = "repro_torch_flash_attention" + ("_wgmma" if route == "wgmma" else "")
    assert ops.ENTRY_LAUNCHES == {entry: 2}


def _breaches(got, want, tol):
    """Whether ``got`` fails ``assert_close(got, want, rtol=tol, atol=tol)``."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() > tol + tol * want.abs()).any())


def _pad_keys(x, n):  # zero keys to n, as a TMA load past T fills them
    return torch.cat([x, x.new_zeros(x.shape[0], n - x.shape[1], *x.shape[2:])], 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,s,t", WHISPER_ATTENTION)
def test_whisper_edge_probe_sees_planted_faults_on_card(cuda, b, s, t, dt):
    """On ``ref.edge_probe``'s inputs the tolerance above fails K4 and K6
    with a planted fault at T = 1,500: the edge mask off (zero-filled keys
    to 1,536 attended), the ragged last tile dropped (T = 1,472) and, for
    K6, ``cur`` one short.  Each fault is the real kernel on the inputs
    the faulty kernel would see."""
    g = torch.Generator(device=cuda).manual_seed(b + s + t)
    whole, cut, tol = -(-t // 64) * 64, t // 64 * 64, TOL[dt]
    q, k, v = ref.edge_probe((b, s, 6, 64), (b, t, 6, 64), dt, g)
    want = ref.flash_attention(q, k, v, causal=False)
    assert not _breaches(ops.flash_attention(q, k, v, causal=False), want, tol)
    assert _breaches(ops.flash_attention(q, _pad_keys(k, whole), _pad_keys(v, whole), False),
                     want, tol)
    assert _breaches(ops.flash_attention(q, k[:, :cut].contiguous(), v[:, :cut].contiguous(),
                                         False), want, tol)
    qd = q[:, 0].contiguous()
    cur = torch.full((b,), t - 1, dtype=torch.int32, device=cuda)
    want = ref.flash_decode(qd, k, v, cur)
    assert not _breaches(ops.flash_decode(qd, k, v, cur), want, tol)
    assert _breaches(ops.flash_decode(qd, k, v, cur - 1), want, tol)
    assert _breaches(ops.flash_decode(qd, _pad_keys(k, whole), _pad_keys(v, whole),
                                      cur + whole - t), want, tol)
    assert _breaches(ops.flash_decode(qd, k[:, :cut].contiguous(), v[:, :cut].contiguous(),
                                      cur + cut - t), want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("curs", ["last", "before_last", "first", "past", "mixed"])
def test_flash_decode_on_whisper_cross_cache_on_card(cuda, curs, b, dt):
    """K6 on whisper-tiny's cross cache (T = 1,500 frames, 6 KV heads of 64,
    a ragged last 64-key tile), every row at T - 1 (what cross-attention
    decode asks), T - 2, 0 or past T, and a mix; B = 1 and 8 (8 and 3
    splits of the cluster kernel)."""
    t = 1500
    value = {"last": t - 1, "before_last": t - 2, "first": 0, "past": t + 9}
    cur = ([0, 63, 64, 511, 512, t - 2, t - 1, t][:b] if curs == "mixed" else [value[curs]] * b)
    g = torch.Generator(device=cuda).manual_seed(b + len(curs))
    q = torch.randn(b, 6, 64, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(b, t, 6, 64, generator=g, device=cuda).to(dt) for _ in range(2))
    pq, pk, pv = ref.edge_probe((b, 1, 6, 64), (b, t, 6, 64), dt, g)
    cur = torch.tensor(cur, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    for q, k, v in ((q, k, v), (pq[:, 0].contiguous(), pk, pv)):
        got = ops.flash_decode(q, k, v, cur)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.flash_decode(q, k, v, cur).float(),
                                   rtol=TOL[dt], atol=TOL[dt])
    entry = {torch.bfloat16: "repro_torch_flash_decode_cluster",
             torch.float32: "repro_torch_flash_decode"}[dt]
    assert ops.ENTRY_LAUNCHES == {entry: 2}


@pytest.mark.gpu
@pytest.mark.parametrize("gather", ["take", "onehot"])
@pytest.mark.parametrize("b,k,d", [(10_000, 5456, 16_609_143), (2501, 4100, 16_609_143),
                                   (1001, 77, 1000), (9, 33, 6), (1, 1, 1)])
def test_csr_dot_kernel_on_card_bit_exact(cuda, b, k, d, gather):
    """Bit-exact against ref.csr_dot (the kernel's summation order), on
    padded rows with duplicate ids; one launch per non-empty call.  The
    SVM path's shape and one with K no multiple of the 256 entries a warp
    takes at a time (8 a lane) and B no multiple of the 8 rows a block,
    both with a w over 50 MB; K below one lane's 8 entries."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["belady", "lru"])
def test_tiered_ragged_plane_feeds_csr_dot_on_card(cuda, tmp_path, policy):
    """The SVM path's read side with the DRAM tier on: a small sparse
    store through the tiered ragged plane (a quarter of the rows cached,
    the fetcher's ``batch_iter`` driving the pipeline) into CSR packing
    and ``csr_dot`` on the card.  Every batch's records equal the direct
    plane's, every margin is bit-exact against ``ref.csr_dot`` on the same
    device tensors, one launch a batch, and the store's counters
    reconcile with the cache's."""
    from repro_torch.core import (InputPipeline, LIRSShuffler, LocationGenerator,
                                  ReadPathConfig, build_data_plane, close_data_plane)
    from repro_torch.data.synthetic import make_classification_dataset
    from repro_torch.storage import RaggedBufferRing, RecordStore
    from repro_torch.svm import pack_csr_batch, pad_csr

    n, dim, batch, epochs = 400, 5000, 50, 2
    path = make_classification_dataset(str(tmp_path / "s.rrec"), n, dim, sparse=True,
                                       nnz_range=(20, 90), seed=3).path
    store = RecordStore(path)
    LocationGenerator().generate(store)
    sh = LIRSShuffler(n, batch, seed=1)
    ring = RaggedBufferRing(batch * (8 + 8 * 90), batch, depth=4)
    plane = build_data_plane(store, ReadPathConfig(
        mode="ragged", ring=ring, workers=2, shuffler=sh, max_epochs=epochs,
        cache_budget_bytes=(n // 4) * int(store.lengths().max()), eviction_policy=policy))
    direct = build_data_plane(store, ReadPathConfig(mode="ragged"))
    w = torch.randn(dim, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    before, batches = ops.LAUNCHES["csr_dot"], 0
    try:
        for e in range(epochs):
            idx_iter = sh.epoch_batches(e)
            pipe = InputPipeline(plane.batch_iter, plane, prefetch=2, num_producers=2,
                                 recycle_fn=ring.recycle)
            for item in pipe.epoch(e):
                assert item.tolist() == direct(next(idx_iter)).tolist()
                idx2d, val2d = pad_csr(pack_csr_batch(item, dim))
                idx = torch.from_numpy(idx2d).to(cuda)
                val = torch.from_numpy(val2d).to(cuda)
                assert torch.equal(ops.csr_dot(idx, val, w), ref.csr_dot(idx, val, w))
                batches += 1
    finally:
        close_data_plane(plane)
    torch.cuda.synchronize()
    assert batches == epochs * n // batch == ops.LAUNCHES["csr_dot"] - before
    assert store.stats.cache_hits == plane.cache.hits > 0
    assert plane.cache.hits + plane.cache.misses == epochs * n
    store.close()


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


def _mixed_tables(cuda, n, r, seed):
    """The DNN path's two tables (f32 128-byte rows, int32 4-byte rows) and
    a bf16 one of 3-wide rows off a 16-byte boundary (2-byte words)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, 32, generator=g, device=cuda)
    y = torch.randint(-2**31, 2**31 - 1, (n, 1), generator=g, device=cuda, dtype=torch.int32)
    z = torch.randn(n + 1, 3, generator=g, device=cuda).to(torch.bfloat16)[1:]
    return (x, y, z), g


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("on_host", [True, False])
@pytest.mark.parametrize("b", [1, 100, 129, 960, 961, 5000])
def test_batch_gather_tables_routes_on_card_bit_exact(cuda, b, on_host, r):
    """One launch for three tables of mixed dtypes and widths, both
    routes: host ids in the launch's parameters up to the 960 cap, the
    loading kernel for device ids and above the cap; duplicate, negative
    and out-of-range ids; bit-exact against ref.batch_gather per table."""
    tables, g = _mixed_tables(cuda, 4096, r, b + r)
    nb = 4096 // r
    idx = torch.randint(-nb - 3, nb + 4, (b,), generator=g, device=cuda, dtype=torch.int32)
    idx[: min(3, b)] = int(idx[-1])
    ids = idx.cpu() if on_host else idx
    route = ops._gather_route(on_host, b)
    assert route == ("params" if on_host and b <= 960 else "load")
    ops.reset_launch_counts()
    got = ops.batch_gather_tables(tables, ids, block_d=1, rows_per_block=r)
    torch.cuda.synchronize()
    for out, t in zip(got, tables):
        assert torch.equal(out, ref.batch_gather(t, idx, r))
    entry = {"params": "repro_torch_gather_tables_params", "load": "repro_torch_gather_tables"}
    assert ops.LAUNCHES["batch_gather"] == 1 and ops.ENTRY_LAUNCHES == {entry[route]: 1}


@pytest.mark.gpu
def test_batch_gather_tables_host_ids_in_a_cuda_graph(cuda):
    """Captured launches of the parameter route keep the ids each was
    given: two captured calls with other host ids replay to their eager
    outputs, and the DeviceTable step makes one launch."""
    tables, g = _mixed_tables(cuda, 1000, 1, 3)
    ids = [torch.randint(0, 1000, (100,), generator=g, dtype=torch.int32, device=cuda).cpu()
           for _ in range(2)]
    want = [ops.batch_gather_tables(tables, i) for i in ids]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.batch_gather_tables(tables, ids[0])
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.batch_gather_tables(tables, i) for i in ids]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for got, exp in zip(outs, want) for o, w in zip(got, exp))

    from repro_torch.data.device_table import DeviceTable

    xs = tables[0].cpu().numpy()
    ys = torch.randint(0, 20, (1000,), generator=g, device=cuda, dtype=torch.int32).cpu().numpy()
    dt = DeviceTable(xs, ys, device=cuda)
    ops.reset_launch_counts()
    x, y = dt.batch(ids[1].numpy())
    torch.cuda.synchronize()
    assert torch.equal(x.cpu(), torch.from_numpy(xs[ids[1].numpy()]))
    assert torch.equal(y.cpu(), torch.from_numpy(ys[ids[1].numpy()]))
    assert ops.ENTRY_LAUNCHES == {"repro_torch_gather_tables_params": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("b", [133, 300, 960, 40000])
def test_batch_gather_tables_many_ids_a_block_repeated_on_card(cuda, b):
    """Launches in which a thread block takes several ids (B above the SM
    count; up to 256 ids a block at B = 40,000): 200 back to back with new
    ids each, host and device ids in turn, every output kept until one
    synchronize, each bit-exact against ref.batch_gather per table."""
    tables, g = _mixed_tables(cuda, 1 << 20, 1, b)
    n = tables[0].shape[0]
    ids = [torch.randint(-n, n + 5, (b,), generator=g, device=cuda, dtype=torch.int32)
           for _ in range(200)]
    host = [i.cpu() for i in ids]
    ops.reset_launch_counts()
    got = [ops.batch_gather_tables(tables, h if k % 2 == 0 else i)
           for k, (i, h) in enumerate(zip(ids, host))]
    torch.cuda.synchronize()
    for i, outs in zip(ids, got):
        for out, t in zip(outs, tables):
            assert torch.equal(out, ref.batch_gather(t, i, 1))
    on_params = 100 if b <= 960 else 0
    assert ops.LAUNCHES["batch_gather"] == 200
    assert ops.ENTRY_LAUNCHES.get("repro_torch_gather_tables_params", 0) == on_params
    assert ops.ENTRY_LAUNCHES["repro_torch_gather_tables"] == 200 - on_params


# batch_gather_dma's ring: (dtype, width, rows_per_block, offset rows) for
# 4-byte label rows (cp.async), 128-byte rows (the DNN path's, bulk
# copies), 2,048-byte rows (a ring that wraps at rows_per_step 64), blocks
# over 16 KB that are no multiple of the 16 KB chunk (16,400 and 32,800
# bytes), and tables off a 16-byte boundary (bf16: 2-byte words, plain
# loads, and 4-byte words; f32 rows of 16,396 bytes in 4-byte words)
RING_CASES = [(torch.int32, 1, 1, 0), (torch.float32, 32, 1, 0), (torch.float32, 512, 1, 0),
              (torch.float32, 4100, 1, 0), (torch.float32, 4100, 2, 0),
              (torch.bfloat16, 3, 1, 1), (torch.bfloat16, 42, 2, 1), (torch.float32, 4099, 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("dt,d,r,off", RING_CASES)
def test_batch_gather_dma_ring_on_card_bit_exact(cuda, dt, d, r, off, m):
    """Every branch of the ring: bulk and staged stages, chunked blocks,
    slot reuse, a ragged last block (205 ids), wrapped and clamped ids."""
    n, b = 1024, 205
    g = torch.Generator(device=cuda).manual_seed(d + r + off + m)
    full = torch.randn(n + off, d, generator=g, device=cuda).mul(1000).to(dt)
    table = full[off:]
    nb = n // r
    idx = torch.randint(-nb - 3, nb + 4, (b,), generator=g, device=cuda, dtype=torch.int32)
    idx[:3] = torch.tensor([-1, -nb - 2, nb + 2], dtype=torch.int32)  # wraps, clamps low, high
    before = ops.LAUNCHES["batch_gather_dma"]
    got = ops.batch_gather_dma(table, idx, block_d=d, rows_per_block=r, rows_per_step=m)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.batch_gather(table, idx, r))
    assert ops.LAUNCHES["batch_gather_dma"] == before + 1


@pytest.mark.gpu
def test_batch_gather_dma_many_rounds_on_card_bit_exact(cuda):
    """rows_per_step far above the 128 stages a round holds: the bulk
    kernel runs 11 rounds a block, its mbarrier parities flipping each."""
    g = torch.Generator(device=cuda).manual_seed(11)
    table = torch.randn(4096, 32, generator=g, device=cuda)
    idx = torch.randint(-4100, 4100, (3000,), generator=g, device=cuda, dtype=torch.int32)
    got = ops.batch_gather_dma(table, idx, block_d=32, rows_per_step=1300)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.batch_gather(table, idx, 1))


# the training path's shape, a ragged one, T = 1, a long T that wraps the
# ring many times and is no multiple of its 128-step tile, W no multiple of
# the 32-channel strip with B > 1 (T over and under one tile), and
# W % 4 != 0 (the lanes kernel)
SCAN_CASES = [(1, 4096, 2560), (3, 1000, 2560 + 96), (2, 1, 40), (1, 33, 1),
              (1, 16385, 2560), (3, 130, 2568), (3, 65, 44), (2, 77, 2562), (4, 64, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,w", SCAN_CASES)
def test_rglru_scan_kernels_on_card_bit_exact(cuda, b, t, w):
    """Forward and reverse against the plain versions, bit for bit, at the
    training path's shape, ragged ones and T = 1; through ops.RGLRUScan,
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
    route = "ring" if w % 4 == 0 else "lanes"
    assert ops._scan_kernel(a, x) == route


def _tma_calls(cuda):
    """The two TMA kernels (wgmma attention, the scan's ring both ways) on
    fixed inputs: a function returning their outputs."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(1, 128, 32, 128, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(1, 128, 8, 128, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    a = torch.rand(2, 300, 2560, generator=g, device=cuda) * 0.4 + 0.6
    x, dh = (torch.randn(2, 300, 2560, generator=g, device=cuda) for _ in range(2))
    h = ref.rglru_scan(a, x)

    def run():
        return (ops.flash_attention(q, k, v), ops.rglru_scan(a, x), *ops.rglru_scan_bwd(a, h, dh))
    return run


@pytest.mark.gpu
def test_tma_launchers_in_a_new_thread_and_a_cuda_graph(cuda):
    """The TMA launchers encode tensor maps on the host: from a thread that
    has made no CUDA call yet (as autograd's backward thread) and while a
    stream is captured into a CUDA graph, they launch and give the eager
    outputs bit for bit."""
    import threading

    run = _tma_calls(cuda)
    assert ops._attention_kernel(torch.bfloat16, 128, 4) == "wgmma"
    want = run()
    torch.cuda.synchronize()
    got = {}

    def worker():
        try:
            got["out"] = run()
            torch.cuda.synchronize()
        except Exception as e:  # surfaced by the assert below
            got["err"] = e

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert "err" not in got, got.get("err")
    assert all(torch.equal(p, r) for p, r in zip(got["out"], want))

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm-up outside the capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    ops.reset_launch_counts()
    with torch.cuda.graph(graph):
        outs = run()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(p, r) for p, r in zip(outs, want))
    assert ops.ENTRY_LAUNCHES == {"repro_torch_flash_attention_wgmma": 1,
                                  "repro_torch_rglru_scan_ring": 1,
                                  "repro_torch_rglru_scan_ring_bwd": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("seed", range(4))
def test_compression_on_card_equals_cpu(cuda, seed, bits):
    """``train/compression.py`` (no kernel) gives the CPU's codes, scale
    and error-feedback residual bit for bit on the card: its divisions
    are by 0-d tensors, since a Python divisor is applied on CUDA as a
    product with its reciprocal, one ulp off the quotient."""
    from repro_torch.train.compression import EFCompressor, quantize

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(100_003, generator=g) * 10.0 ** (seed - 2)
    r = torch.randn(100_003, generator=g) * 10.0 ** (seed - 4)
    codes, s = quantize(x.to(cuda), bits)
    want_codes, want_s = quantize(x, bits)
    assert torch.equal(codes.cpu(), want_codes) and torch.equal(s.cpu(), want_s)
    comp = EFCompressor(bits)
    (c, sc), nr = comp.compress([x.to(cuda)], [r.to(cuda)])
    (want_c, want_sc), want_nr = comp.compress([x], [r])
    assert torch.equal(c[0].cpu(), want_c[0]) and torch.equal(sc[0].cpu(), want_sc[0])
    assert torch.equal(nr[0].cpu(), want_nr[0])
