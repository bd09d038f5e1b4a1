"""The port's DNN path (paper Tables 6–7, Fig 3) against the JAX package.

The same numpy inputs, made from a seed, go through both packages: the
clustered data, the LIRS gathers (the JAX side runs the Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` does, and their jnp
reference), the MLP's SGD step with carried weights, and the whole
TFIP-against-LIRS run of ``benchmarks/dnn_convergence.py`` and the queue
sweep of ``benchmarks/queue_size.py`` at a small size, with the JAX
models' initial weights injected into the port.

Tolerances: data bytes and gathers are held bit-identical (both copy
bytes); losses, parameters and validation trajectories to 1e-5 (autograd
against ``jax.value_and_grad``, both f32, products summed in other
orders); epoch counts and test accuracies exactly.  The CUDA kernels
themselves are tested in ``test_torch_gpu.py``.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # the JAX benchmarks are driven as they stand
    sys.path.insert(0, ROOT)

from benchmarks import dnn_convergence as jconv  # noqa: E402
from benchmarks import queue_size as jqueue  # noqa: E402
from repro.core.shuffler import LIRSShuffler as JLIRS  # noqa: E402
from repro.core.shuffler import TFIPShuffler as JTFIP  # noqa: E402
from repro.dnn import mlp as jmlp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import LIRSShuffler, TFIPShuffler  # noqa: E402
from repro_torch.data.device_table import DeviceTable  # noqa: E402
from repro_torch.dnn import convergence, mlp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

TOL = 1e-5
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _jax_init(dims, seed):
    """The JAX MLPClassifier's initial weights, carried into the port."""
    return params_from_jax(jmlp._init(jax.random.PRNGKey(seed), dims))


def _bits(a):
    """An array's raw bytes as integers (bf16 has no numpy dtype)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ----------------------------------------------------------------- data


@pytest.mark.parametrize(
    "n,dim,classes,seed,class_sorted",
    [(12000, 32, 20, 42, True), (2000, 32, 20, 7, False), (1234, 16, 10, 3, True)],
)
def test_make_clustered_data_same_bytes(n, dim, classes, seed, class_sorted):
    want = jmlp.make_clustered_data(n, dim, classes, seed=seed, class_sorted=class_sorted)
    got = mlp.make_clustered_data(n, dim, classes, seed=seed, class_sorted=class_sorted)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    # a matched split from given centers
    want = jmlp.make_clustered_data(400, dim, classes, seed=99, class_sorted=False,
                                    centers=want[2])
    got = mlp.make_clustered_data(400, dim, classes, seed=99, class_sorted=False,
                                  centers=got[2])
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


@pytest.mark.parametrize("queue", [1, 60, 5000])
def test_shuffler_batches_match_jax(queue):
    """The index stream the gathers consume: TFIP and LIRS, ragged tail."""
    n = 1234
    pairs = [(TFIPShuffler(n, 100, queue, seed=2), JTFIP(n, 100, queue, seed=2)),
             (LIRSShuffler(n, 100, seed=2), JLIRS(n, 100, seed=2))]
    for port, ref in pairs:
        for e in range(2):
            got, want = list(port.epoch_batches(e)), list(ref.epoch_batches(e))
            assert len(got) == len(want) == 13 and len(got[-1]) == 34
            assert all(np.array_equal(g, w) for g, w in zip(got, want))


# -------------------------------------------------------------- gathers

# (n, d, b, block_d, rows_per_block, rows_per_step): test_kernels.py's
# sweeps, ragged B against rows_per_step, and page blocks
GATHER_CASES = [
    (64, 256, 16, 128, 1, 8), (128, 512, 5, 512, 1, 8), (32, 128, 32, 128, 1, 1),
    (64, 128, 7, 128, 1, 16), (128, 256, 8, 512, 2, 4), (128, 256, 9, 256, 4, 4),
    (128, 256, 8, 512, 8, 8), (40, 1, 13, 512, 1, 8),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("kernel", ["batch_gather", "batch_gather_dma"])
def test_batch_gather_matches_pallas(kernel, case, dtype):
    """Bit for bit against the Pallas kernel (interpret mode) and its jnp
    reference, with out-of-range ids on both sides of the table."""
    n, d, b, block_d, r, m = case
    rng = np.random.default_rng(n * 31 + d + b + r)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, size=(n, d)).astype(np.int32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
    nb = n // r
    idx = rng.integers(-nb - 3, nb + 4, size=b).astype(np.int32)
    idx[:2] = idx[2]  # duplicates
    table_j, idx_j = jnp.asarray(x, JNP_DT[dtype]), jnp.asarray(idx)
    table_t, idx_t = torch.from_numpy(x).to(TORCH_DT[dtype]), torch.from_numpy(idx)
    if kernel == "batch_gather":
        want = jops.batch_gather(table_j, idx_j, block_d=block_d, rows_per_block=r)
        got = ops.batch_gather(table_t, idx_t, block_d=block_d, rows_per_block=r)
    else:
        want = jops.batch_gather_dma(table_j, idx_j, block_d=block_d, rows_per_block=r,
                                     rows_per_step=m)
        got = ops.batch_gather_dma(table_t, idx_t, block_d=block_d, rows_per_block=r,
                                   rows_per_step=m)
    assert got.dtype == TORCH_DT[dtype] and tuple(got.shape) == (b * r, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(jref.batch_gather_ref(table_j, idx_j, r)))


@pytest.mark.parametrize("r", [1, 2, 4])
def test_out_of_range_ids_wrap_once_then_clamp(r):
    """8 blocks: [0, 7, 9, -1, -9, -8, -7, 100, -100] → [0, 7, 7, 7, 0, 0, 1, 7, 0],
    as batch_gather_ref and the Pallas kernels (interpret mode) give."""
    table = torch.arange(8 * r, dtype=torch.float32)[:, None].repeat(1, 4)
    idx = torch.tensor([0, 7, 9, -1, -9, -8, -7, 100, -100], dtype=torch.int32)
    for fn in (ops.batch_gather, ops.batch_gather_dma):
        out = fn(table, idx, rows_per_block=r)
        assert (out[::r, 0] // r).long().tolist() == [0, 7, 7, 7, 0, 0, 1, 7, 0]


@pytest.mark.parametrize("kernel", ["batch_gather", "batch_gather_dma"])
def test_gather_wrappers_check_their_inputs(kernel):
    """They raise where the JAX wrappers assert (N % r, D % block_d), on a
    dtype the kernels do not take, and return (0, D) for B = 0."""
    fn = getattr(ops, kernel)
    table = torch.zeros(12, 64)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="blocks of 5"):
        fn(table, idx, rows_per_block=5)
    with pytest.raises(ValueError, match="block_d 48"):
        fn(table, idx, block_d=48)
    with pytest.raises(TypeError, match="float32/bfloat16/int32"):
        fn(table.double(), idx)
    with pytest.raises(TypeError, match="integers"):
        fn(table, idx.float())
    with pytest.raises(ValueError, match="table \\(N,D\\)"):
        fn(table[0], idx)
    before = dict(ops.LAUNCHES)
    empty = fn(table, idx[:0], rows_per_block=4)
    assert tuple(empty.shape) == (0, 64) and ops.LAUNCHES == before
    # int64 ids are taken as JAX takes them (astype int32)
    assert torch.equal(fn(table + torch.arange(12.0)[:, None], idx.long())[:, 0],
                       torch.tensor([0.0, 1.0]))
    if kernel == "batch_gather_dma":
        with pytest.raises(ValueError, match="rows_per_step"):
            fn(table, idx, rows_per_step=0)


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("hidden", [(64,), (256, 128, 64)])
def test_mlp_train_batch_matches_jax(hidden):
    """Five SGD+momentum steps from carried weights: losses and params."""
    rng = np.random.default_rng(len(hidden))
    jm = jmlp.MLPClassifier(32, 20, hidden=hidden, seed=3)
    pm = mlp.MLPClassifier(32, 20, hidden=hidden, device="cpu",
                           params=params_from_jax(jm.params))
    for step in range(5):
        b = 100 if step < 4 else 37  # and a ragged batch
        x = rng.normal(size=(b, 32)).astype(np.float32)
        y = rng.integers(0, 20, size=b).astype(np.int32)
        want = jm.train_batch(x, y)
        got = pm.train_batch(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (step, got, want)
    for jl, pl in zip(jm.params, pm.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(pl[k].detach().numpy(), np.asarray(jl[k]),
                                       rtol=TOL, atol=TOL)
    x = rng.normal(size=(300, 32)).astype(np.float32)
    y = rng.integers(0, 20, size=300).astype(np.int32)
    assert abs(pm.loss(x, y) - jm.loss(x, y)) <= TOL
    assert pm.accuracy(x, y) == jm.accuracy(x, y)


def test_mlp_default_init_shapes_and_device():
    m = mlp.MLPClassifier(32, 20, hidden=(16, 8), seed=0, device="cpu")
    assert [tuple(p["w"].shape) for p in m.params] == [(32, 16), (16, 8), (8, 20)]
    assert all(not p["b"].any() for p in m.params)
    again = mlp.MLPClassifier(32, 20, hidden=(16, 8), seed=0, device="cpu")
    assert torch.equal(m.params[0]["w"], again.params[0]["w"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mlp.MLPClassifier(32, 20)


# ----------------------------------------------------------- the slice


@pytest.mark.parametrize("gather", ["block", "dma"])
@pytest.mark.parametrize("shuffler", ["lirs", "tfip"])
def test_device_table_batches_equal_host_indexing(gather, shuffler):
    """What ``dnn_convergence.py:35`` does as ``xs[idx]``: every batch of an
    epoch, the ragged last one included, and the rows counted."""
    xs, ys, _ = mlp.make_clustered_data(1240, 32, 20, seed=1)
    table = DeviceTable(xs, ys, device="cpu", gather=gather, rows_per_step=8)
    sh = (LIRSShuffler(1240, 100, seed=4) if shuffler == "lirs"
          else TFIPShuffler(1240, 100, queue_size=60, seed=4))
    batches = list(sh.epoch_batches(1))
    assert len(batches[-1]) == 40
    for idx in batches:
        x, y = table.batch(idx)
        assert x.dtype == torch.float32 and y.dtype == torch.int32
        assert np.array_equal(x.numpy(), xs[idx]) and np.array_equal(y.numpy(), ys[idx])
    assert table.rows == 1240
    with pytest.raises(ValueError, match="gather must be"):
        DeviceTable(xs, ys, device="cpu", gather="take")


def _patched(monkeypatch, module, **consts):
    monkeypatch.setattr(module, "cached", lambda name, fn, force=False: fn())
    for k, v in consts.items():
        monkeypatch.setattr(module, k, v)
    return module.run()


@pytest.mark.parametrize("gather", ["block", "dma"])
def test_convergence_matches_jax_run(monkeypatch, gather):
    """``dnn_convergence``'s TFIP-against-LIRS run at N = 1,200, hidden
    (64,), 2 epochs, one seed, queue 60: trajectories within 1e-5, the same
    epochs for LIRS and the same test accuracies."""
    want = _patched(monkeypatch, jconv, N=1200, E_MAX=2, QUEUE=60,
                    MODELS={"alexnet-like": (64,)}, SEEDS=(0,))["alexnet-like"]
    runs = []
    got = convergence.compute(n=1200, queue=60, epochs=2, models={"alexnet-like": (64,)},
                              seeds=(0,), gather=gather, device="cpu", init=_jax_init,
                              runs=runs)["alexnet-like"]
    assert set(got) == set(want)
    for k in ("val_traj_tfip", "val_traj_lirs"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
    for k in ("epochs_tfip", "epochs_lirs_mean", "epochs_lirs_per_seed", "acc_tfip",
              "acc_lirs", "acc_improvement"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert [(kind, r.rows, len(r.losses), len(r.losses[0])) for _, _, kind, r in runs] == \
        [("tfip", 2400, 2, 12), ("lirs", 2400, 2, 12)]


def test_queue_sweep_matches_jax(monkeypatch):
    """``queue_size``'s sweep at N = 1,200, queues (1, 60), 2 epochs."""
    want = _patched(monkeypatch, jqueue, N=1200, EPOCHS=2, QUEUES=[1, 60], SEEDS=(0,))
    got = convergence.queue_sweep(n=1200, queues=(1, 60), epochs=2, seeds=(0,),
                                  device="cpu", init=_jax_init)
    assert got == want


def test_convergence_cli_on_cpu(capsys):
    out = convergence.main(["--device", "cpu", "--n", "400", "--epochs", "1", "--seeds", "0",
                            "--models", "alexnet-like", "--queue", "20", "--gather", "dma"])
    printed = capsys.readouterr().out
    assert '"alexnet-like"' in printed and out["alexnet-like"]["epochs_tfip"] == 1
    with pytest.raises(SystemExit):
        convergence.main(["--device", "cpu", "--models", "resnet"])
