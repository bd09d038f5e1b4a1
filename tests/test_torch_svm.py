"""The port's sparse-SVM training path against the JAX package.

The same numpy inputs, made from a seed, go through both packages: the
record store and its ragged read path, the LIRS/BMF shufflers, CSR
packing, the DCD solver and the linear SVM, the ``csr_dot`` kernel's
plain version (the JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does), and the whole path of
``tests/test_svm_dcd.py::test_svm_end_to_end_through_ragged_pipeline``.

Tolerances: the host-side arrays, files, ``w`` and ``alpha`` are held
bit-identical (the numpy code is the same).  ``csr_dot`` sums in another
order than XLA's reduce, so each row is held to
``1e-6 · Σ_k |values·w[idx]|``, a scale that survives cancellation;
objectives built on it to 1e-6 relative; ``LinearSVM`` (autograd against
``jax.value_and_grad``, both f32) to 1e-5.  The CUDA kernel itself is
tested in ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ReadPathConfig as JReadPathConfig
from repro.core import build_data_plane as jbuild_data_plane
from repro.core.location import LocationGenerator as JLocationGenerator
from repro.core.pipeline import InputPipeline as JInputPipeline
from repro.core.shuffler import BMFShuffler as JBMF
from repro.core.shuffler import LIRSShuffler as JLIRS
from repro.data.synthetic import make_classification_dataset as jmake
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.storage.record_store import RaggedBufferRing as JRing
from repro.storage.record_store import RecordStore as JStore
from repro.svm.dcd import DCDSolver as JDCD
from repro.svm.linear import LinearSVM as JLinearSVM
from repro.svm.sparse import pack_csr_batch as jpack
from repro.svm.sparse import pad_csr as jpad
from repro_torch.core import (
    BMFShuffler,
    InputPipeline,
    LIRSShuffler,
    LocationGenerator,
    ReadPathConfig,
    build_data_plane,
)
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.kernels import ops
from repro_torch.storage import RaggedBufferRing, RecordStore
from repro_torch.svm import LinearSVM, pack_csr_batch, pad_csr
from repro_torch.svm.dcd import DCDSolver


def _rows_close(got, want, idx, val, w):
    """Per-row |got − want| <= 1e-6 · Σ_k |values·w[idx]|."""
    scale = np.abs(val.astype(np.float64) * w.astype(np.float64)[idx]).sum(1)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-6 * scale).all(), (err, scale)


def _padded_case(seed, b, k, d):
    """Padded CSR rows (random suffix zero-padded, as pad_csr leaves them)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(b, k)).astype(np.int32)
    val = rng.normal(size=(b, k)).astype(np.float32)
    keep = rng.integers(1, k + 1, size=b)
    mask = np.arange(k)[None, :] < keep[:, None]
    idx, val = np.where(mask, idx, 0).astype(np.int32), np.where(mask, val, 0).astype(np.float32)
    return idx, val, rng.normal(size=d).astype(np.float32)


def _stores(tmp_path, n, dim, nnz, seed, noise=0.02):
    """One sparse file written by each package's generator, opened with
    each package's store and indexed by its location generator."""
    jm = jmake(str(tmp_path / "jax.rrec"), n, dim, sparse=True,
               nnz_range=nnz, noise=noise, seed=seed)
    tm = make_classification_dataset(str(tmp_path / "torch.rrec"), n, dim, sparse=True,
                                     nnz_range=nnz, noise=noise, seed=seed)
    js, ts = JStore(jm.path), RecordStore(tm.path)
    JLocationGenerator().generate(js)
    LocationGenerator().generate(ts)
    return js, ts


# ----------------------------------------------------------------- csr_dot


@pytest.mark.parametrize("gather", ["take", "onehot"])
@pytest.mark.parametrize(
    "b,k,d,block_b",
    [(16, 8, 128, 8), (5, 24, 64, 8), (32, 16, 256, 4), (1, 8, 32, 8),
     (33, 40, 512, 16), (37, 70, 300, 8), (9, 33, 6, 8)],  # ragged B; dense duplicates
)
def test_csr_dot_matches_pallas_kernel(b, k, d, block_b, gather):
    idx, val, w = _padded_case(b * 1000 + k, b, k, d)
    got = ops.csr_dot(torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(w),
                      block_b=block_b, gather=gather).numpy()
    want = jops.csr_dot(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(w),
                        block_b=block_b, gather=gather)
    _rows_close(got, want, idx, val, w)
    _rows_close(got, jref.csr_dot_ref(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(w)),
                idx, val, w)
    assert got.dtype == np.float32 and got.shape == (b,)


def test_csr_dot_duplicates_and_empty_batch():
    ops.reset_launch_counts()
    idx = torch.tensor([[3, 3, 0, 0]], dtype=torch.int32)
    val = torch.tensor([[1.5, 2.5, 0.0, 0.0]])
    w = torch.arange(8, dtype=torch.float32)
    assert ops.csr_dot(idx, val, w).tolist() == [12.0]  # 4.0 · w[3]
    empty = ops.csr_dot(torch.zeros(0, 8, dtype=torch.int32), torch.zeros(0, 8), w)
    assert empty.shape == (0,) and empty.dtype == torch.float32
    assert ops.LAUNCHES["csr_dot"] == 0
    with pytest.raises(ValueError, match="gather must be"):
        ops.csr_dot(idx, val, w, gather="dense")


# ------------------------------------------- generator, read path, packing


@pytest.mark.parametrize("sparse,dim,nnz", [(True, 64, (4, 16)), (True, 5000, (20, 90)),
                                            (False, 24, (8, 64))])
def test_generator_files_byte_identical(tmp_path, sparse, dim, nnz):
    jm = jmake(str(tmp_path / "j.rrec"), 150, dim, sparse=sparse, nnz_range=nnz,
               noise=0.05, seed=3)
    tm = make_classification_dataset(str(tmp_path / "t.rrec"), 150, dim, sparse=sparse,
                                     nnz_range=nnz, noise=0.05, seed=3)
    assert (tmp_path / "j.rrec").read_bytes() == (tmp_path / "t.rrec").read_bytes()
    assert (jm.num_records, jm.dim, jm.avg_record_bytes, jm.total_bytes) == (
        tm.num_records, tm.dim, tm.avg_record_bytes, tm.total_bytes)


def test_ragged_read_packing_and_padding_identical(tmp_path):
    js, ts = _stores(tmp_path, 300, 96, (2, 20), seed=4)
    np.testing.assert_array_equal(ts.offsets(), js.offsets())
    idx = np.random.default_rng(0).integers(0, 300, size=120)  # repeats included
    for kw in ({}, {"workers": 3, "gap_bytes": 0}):
        jb, tb = js.read_batch_ragged(idx, **kw), ts.read_batch_ragged(idx, **kw)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)
        tc, jc = pack_csr_batch(tb, 96), jpack(jb, 96)
        for a, b in zip(tc, jc):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for k in (0, 24):
            for a, b in zip(pad_csr(tc, k), jpad(jc, k)):
                np.testing.assert_array_equal(a, b)
    js.close()
    ts.close()


@pytest.mark.parametrize("kind", ["lirs-table", "lirs-feistel", "lirs-ragged-tail", "bmf"])
def test_shuffler_epoch_batches_identical(kind):
    n = 1003
    if kind == "bmf":
        pair = BMFShuffler(n, 7, seed=2), JBMF(n, 7, seed=2)
    else:
        assignment = "feistel" if kind == "lirs-feistel" else "table"
        bs = 97 if kind == "lirs-ragged-tail" else 100
        pair = (LIRSShuffler(n, bs, seed=2, assignment=assignment),
                JLIRS(n, bs, seed=2, assignment=assignment))
    for e in range(3):
        got, want = list(pair[0].epoch_batches(e)), list(pair[1].epoch_batches(e))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- DCD


def _dup_batch(rng, b, dim):
    """A CSR batch whose rows list some feature ids twice."""
    from repro_torch.svm.sparse import CSRBatch

    nnz = rng.integers(1, 12, size=b)
    cols = rng.integers(0, dim, size=int(nnz.sum())).astype(np.int32)
    cols[1::5] = cols[::5][: len(cols[1::5])]
    row_ptr = np.concatenate(([0], np.cumsum(nnz))).astype(np.int32)
    return CSRBatch(cols, rng.normal(size=len(cols)).astype(np.float32), row_ptr,
                    np.where(rng.random(b) < 0.5, -1.0, 1.0).astype(np.float32))


@pytest.mark.parametrize("source", ["store", "duplicates"])
def test_solve_block_csr_bit_identical(tmp_path, source):
    n, dim = 240, 80
    rng = np.random.default_rng(11)
    if source == "store":
        js, ts = _stores(tmp_path, n, dim, (3, 15), seed=9)
        batches = [(pack_csr_batch(ts.read_batch_ragged(blk), dim),
                    jpack(js.read_batch_ragged(blk), dim), blk)
                   for blk in np.array_split(rng.permutation(n), 4)]
    else:
        batches = []
        for blk in np.array_split(rng.permutation(n), 4):
            csr = _dup_batch(rng, len(blk), dim)
            batches.append((csr, csr, blk))
    port, ref = DCDSolver(dim, n, C=0.5, device="cpu"), JDCD(dim, n, C=0.5)
    for _ in range(2):
        for tc, jc, blk in batches:
            port.solve_block_csr(tc, blk, sweeps=3)
            ref.solve_block_csr(jc, blk, sweeps=3)
    np.testing.assert_array_equal(port.w, ref.w)
    np.testing.assert_array_equal(port.alpha, ref.alpha)
    assert np.abs(port.w).sum() > 0
    for tc, jc, _ in batches:
        np.testing.assert_array_equal(DCDSolver._row_sq_norms(tc.row_ptr, tc.indices, tc.values),
                                      JDCD._row_sq_norms(jc.row_ptr, jc.indices, jc.values))
        got, want = port.primal_objective_csr(tc), ref.primal_objective_csr(jc)
        assert abs(got - want) <= 1e-6 * abs(want)
        idx2d, val2d = pad_csr(tc)
        _rows_close(port.margins_csr(tc), ref.margins_csr(jc), idx2d, val2d,
                    port.w.astype(np.float32))
    if source == "store":
        js.close()
        ts.close()


@pytest.mark.parametrize("inner_steps", [1, 4])
def test_linear_svm_matches_jax(inner_steps):
    rng = np.random.default_rng(inner_steps)
    dim = 20
    port, ref = LinearSVM(dim, lam=1e-3, lr=0.1, device="cpu"), JLinearSVM(dim, lam=1e-3, lr=0.1)
    for _ in range(5):
        x = rng.normal(size=(32, dim)).astype(np.float32)
        y = np.where(x[:, 0] + 0.3 * x[:, 1] > 0, 1.0, -1.0).astype(np.float32)
        got, want = port.train_batch(x, y, inner_steps), ref.train_batch(x, y, inner_steps)
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    np.testing.assert_allclose(port.w.numpy(), np.asarray(ref.w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(port.b), float(ref.b), rtol=1e-5, atol=1e-5)
    assert abs(port.objective(x, y) - ref.objective(x, y)) <= 1e-5
    assert port.accuracy(x, y) == ref.accuracy(x, y)


# --------------------------------------------------------- the whole slice


def test_svm_path_matches_jax_end_to_end(tmp_path):
    """store → LIRS shuffler → multi-producer ragged pipeline with ring
    recycling → CSR packing → DCD, then the kernel-backed objective and
    held-out margins, through both packages from one seed."""
    n_train, n_test, dim, batch = 320, 80, 64, 64
    js, ts = _stores(tmp_path, n_train + n_test, dim, (4, 16), seed=1)
    port, ref = DCDSolver(dim, n_train, device="cpu"), JDCD(dim, n_train)
    consumed = {"port": 0, "jax": 0}

    def run(solver, key, shuffler, pipe, pack):
        for e in range(3):
            idx_iter = shuffler.epoch_batches(e)
            for item in pipe.epoch(e):
                idx = next(idx_iter)
                csr = pack(item, dim)
                solver.solve_block_csr(csr, idx, sweeps=3)
                consumed[key] += len(csr)

    sh, ring = LIRSShuffler(n_train, batch, seed=5), RaggedBufferRing(batch * 200, batch, depth=6)
    plane = build_data_plane(ts, ReadPathConfig(mode="ragged", ring=ring, workers=2))
    run(port, "port", sh, InputPipeline(sh.epoch_batches, plane, prefetch=2,
                                        num_producers=3, recycle_fn=ring.recycle),
        pack_csr_batch)
    jsh, jring = JLIRS(n_train, batch, seed=5), JRing(batch * 200, batch, depth=6)
    jplane = jbuild_data_plane(js, JReadPathConfig(mode="ragged", ring=jring, workers=2))
    run(ref, "jax", jsh, JInputPipeline(jsh.epoch_batches, jplane, prefetch=2,
                                        num_producers=3, recycle_fn=jring.recycle),
        jpack)

    assert consumed["port"] == consumed["jax"] == 3 * n_train
    np.testing.assert_array_equal(port.w, ref.w)
    np.testing.assert_array_equal(port.alpha, ref.alpha)
    train = np.arange(n_train)
    test = np.arange(n_train, n_train + n_test)
    obj = port.primal_objective_csr(pack_csr_batch(ts.read_batch_ragged(train), dim))
    jobj = ref.primal_objective_csr(jpack(js.read_batch_ragged(train), dim))
    assert abs(obj - jobj) <= 1e-6 * abs(jobj)
    tcsr, jcsr = pack_csr_batch(ts.read_batch_ragged(test), dim), jpack(js.read_batch_ragged(test), dim)
    m, jm = port.margins_csr(tcsr), ref.margins_csr(jcsr)
    _rows_close(m, jm, *pad_csr(tcsr), port.w.astype(np.float32))
    acc = float((np.where(m >= 0, 1.0, -1.0) == tcsr.labels).mean())
    jacc = float((np.where(jm >= 0, 1.0, -1.0) == jcsr.labels).mean())
    assert acc == jacc and acc > 0.75
    js.close()
    ts.close()


def test_svm_path_through_the_tier_matches_jax(tmp_path):
    """The same path with the DRAM tier on in both packages (a Belady
    tier holding a quarter of the rows, the ragged ring, the fetcher's
    ``batch_iter`` feeding the pipeline): ``w`` and ``alpha`` are
    bit-identical to the JAX run's and to the port's direct run, and the
    store's counters reconcile with the cache's."""
    n_train, dim, batch, epochs = 320, 64, 64, 3
    js, ts = _stores(tmp_path, n_train, dim, (4, 16), seed=1)
    budget = (n_train // 4) * int(ts.lengths().max())
    solvers = {}
    for key, store, shuffler, ring, mod in (
            ("tier", ts, LIRSShuffler, RaggedBufferRing, None),
            ("jax", js, JLIRS, JRing, "jax"),
            ("direct", ts, LIRSShuffler, RaggedBufferRing, None)):
        sh, rg = shuffler(n_train, batch, seed=5), ring(batch * 200, batch, depth=6)
        cfg = dict(mode="ragged", ring=rg, workers=2, shuffler=sh, max_epochs=epochs,
                   eviction_policy="belady", cache_budget_bytes=0 if key == "direct" else budget)
        if mod == "jax":
            plane = jbuild_data_plane(store, JReadPathConfig(**cfg))
            pipe = JInputPipeline(plane.batch_iter, plane, prefetch=2, num_producers=3,
                                  recycle_fn=rg.recycle)
            solver, pack = JDCD(dim, n_train), jpack
        else:
            plane = build_data_plane(store, ReadPathConfig(**cfg))
            pipe = InputPipeline(getattr(plane, "batch_iter", sh.epoch_batches), plane,
                                 prefetch=2, num_producers=3, recycle_fn=rg.recycle)
            solver, pack = DCDSolver(dim, n_train, device="cpu"), pack_csr_batch
        store.stats.reset()
        for e in range(epochs):
            idx_iter = sh.epoch_batches(e)
            for item in pipe.epoch(e):
                solver.solve_block_csr(pack(item, dim), next(idx_iter), sweeps=3)
        if key != "direct":
            plane.close()
            assert store.stats.cache_hits == plane.cache.hits > 0
            assert plane.cache.hits + plane.cache.misses == epochs * n_train
        solvers[key] = solver
    for key in ("jax", "direct"):
        np.testing.assert_array_equal(solvers["tier"].w, solvers[key].w)
        np.testing.assert_array_equal(solvers["tier"].alpha, solvers[key].alpha)
    js.close()
    ts.close()


# -------------------------------------------------- device and fallback


def test_no_silent_fallbacks():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DCDSolver(16, 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LinearSVM(16)
