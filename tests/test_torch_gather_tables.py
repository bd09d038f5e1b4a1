"""``ops.batch_gather_tables`` (one ``batch_gather`` launch for several
tables) and its route between the two CUDA kernels, on the CPU.

On the CPU the wrapper runs ``ref.batch_gather`` once a table; each
output is held bit for bit against the JAX ``batch_gather`` (the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and its
jnp reference on the same numpy ids.  Which CUDA kernel a call on the
card takes is decided before the launch by ``ops._gather_route``, which
is tested here; the kernels themselves are tested in
``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import LIRSShuffler
from repro_torch.data.device_table import DeviceTable
from repro_torch.dnn import mlp
from repro_torch.kernels import ops


def _tables(rng, n, widths):
    """An f32 table and an int32 one per width pair, as numpy arrays."""
    f32 = rng.normal(size=(n, widths[0])).astype(np.float32)
    i32 = rng.integers(-2**31, 2**31 - 1, size=(n, widths[1])).astype(np.int32)
    return f32, i32


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("b", [1, 37, 200])
@pytest.mark.parametrize("as_numpy", [False, True])
def test_tables_match_pallas_per_table(r, b, as_numpy):
    """f32 and int32 tables of other widths, gathered by the same ids with
    duplicates, negative and out-of-range ids: each output equals the
    Pallas kernel's and the jnp reference's, bit for bit."""
    rng = np.random.default_rng(b * 10 + r)
    n = 64 * r
    f32, i32 = _tables(rng, n, (32, 1))
    nb = n // r
    idx = rng.integers(-nb - 5, nb + 6, size=b).astype(np.int32)
    idx[: min(3, b)] = idx[-1]
    ids = idx if as_numpy else torch.from_numpy(idx)
    got = ops.batch_gather_tables((torch.from_numpy(f32), torch.from_numpy(i32)), ids,
                                  block_d=32, rows_per_block=r)
    assert [g.dtype for g in got] == [torch.float32, torch.int32]
    for g, x in zip(got, (f32, i32)):
        xj = jnp.asarray(x)
        want = jops.batch_gather(xj, jnp.asarray(idx), block_d=x.shape[1], rows_per_block=r)
        assert g.shape == (b * r, x.shape[1])
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jref.batch_gather_ref(xj, jnp.asarray(idx), r)))
        assert torch.equal(ops.batch_gather(torch.from_numpy(x), ids, block_d=x.shape[1],
                                            rows_per_block=r), g)


def test_tables_of_other_row_counts_clamp_each_to_its_own():
    """The ids are shared; each table wraps and clamps them against its own
    block count, as one batch_gather call a table would."""
    a = torch.arange(10, dtype=torch.float32)[:, None].repeat(1, 4)
    b = torch.arange(4, dtype=torch.int32)[:, None]
    idx = torch.tensor([0, 3, 5, 9, -1, -5, 12], dtype=torch.int32)
    ga, gb = ops.batch_gather_tables([a, b], idx)
    assert ga[:, 0].tolist() == [0, 3, 5, 9, 9, 5, 9]
    assert gb[:, 0].tolist() == [0, 3, 3, 3, 3, 0, 3]


def test_tables_empty_batch_launches_nothing_and_checks_raise():
    x, y = torch.zeros(12, 8), torch.zeros(12, 1, dtype=torch.int32)
    ops.reset_launch_counts()
    out = ops.batch_gather_tables((x, y), np.zeros(0, np.int32))
    assert [tuple(o.shape) for o in out] == [(0, 8), (0, 1)]
    assert ops.LAUNCHES["batch_gather"] == 0 and ops.ENTRY_LAUNCHES == {}
    idx = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to 4 tables"):
        ops.batch_gather_tables((), idx)
    with pytest.raises(ValueError, match="1 to 4 tables"):
        ops.batch_gather_tables((x,) * 5, idx)
    with pytest.raises(ValueError, match="blocks of 5"):
        ops.batch_gather_tables((x, y), idx, rows_per_block=5)
    with pytest.raises(TypeError, match="float32/bfloat16/int32"):
        ops.batch_gather_tables((x, y.double()), idx)
    with pytest.raises(TypeError, match="integers"):
        ops.batch_gather_tables((x, y), idx.float())
    with pytest.raises(ValueError, match="several devices"):
        ops.batch_gather_tables((x, y.to("meta")), idx)
    with pytest.raises(ValueError, match="several devices"):
        ops.batch_gather_tables((x, y), idx.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.batch_gather_tables((x.to("meta"), y.to("meta")), idx)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.batch_gather(x.to("meta"), idx)  # host ids with tables on another device


@pytest.mark.parametrize("on_host,b,route", [
    (True, 1, "params"), (True, 100, "params"),  # the DNN path's batch
    (True, 129, "params"), (True, 500, "params"),
    (True, 960, "params"),  # the cap
    (True, 961, "load"), (True, 8192, "load"),  # above it: copied to the device
    (False, 1, "load"), (False, 100, "load"), (False, 960, "load"), (False, 8192, "load"),
])
def test_gather_route(on_host, b, route):
    assert ops._PARAM_IDS == 960
    assert ops._gather_route(on_host, b) == route


def test_device_table_block_batches_equal_host_indexing_and_count_rows():
    """DeviceTable.batch through the fused wrapper (gather="block") gives
    xs[idx], ys[idx] for numpy, list and int64 ids, ragged last batch
    included."""
    xs, ys, _ = mlp.make_clustered_data(1000, 32, 20, seed=5)
    table = DeviceTable(xs, ys, device="cpu")
    batches = list(LIRSShuffler(1000, 96, seed=1).epoch_batches(0))
    assert len(batches[-1]) == 1000 % 96
    for k, idx in enumerate(batches):
        ids = list(map(int, idx)) if k % 3 == 1 else (idx.astype(np.int64) if k % 3 else idx)
        x, y = table.batch(ids)
        assert x.shape == (len(idx), 32) and y.shape == (len(idx),)
        assert np.array_equal(x.numpy(), xs[idx]) and np.array_equal(y.numpy(), ys[idx])
    assert table.rows == 1000
