"""The port's meta-device input specs (``repro_torch.launch.input_specs``)
against JAX's ``eval_shape`` specs: for every runnable (arch × shape)
cell, the step kind and every leaf's shape and dtype, in JAX's leaf
order."""
import jax
import pytest

from repro.configs import all_cells as jax_cells
from repro.configs import get_config as jax_config
from repro.launch import input_specs as jspecs
from repro_torch.configs import all_cells, get_config
from repro_torch.launch import input_specs as tspecs
from repro_torch.utils.tree import tree_leaves


def test_cells_equal_jax():
    assert sorted(all_cells()) == sorted(jax_cells())


@pytest.mark.parametrize("arch,shape", sorted(jax_cells()))
def test_input_specs_equal_jax_eval_shape(arch, shape):
    jkind, jargs = jspecs.input_specs(jax_config(arch), shape)
    tkind, targs = tspecs.input_specs(get_config(arch), shape)
    assert tkind == jkind
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree_util.tree_leaves(jargs)]
    leaves = tree_leaves(targs)
    assert all(x.device.type == "meta" for x in leaves)
    got = [(tuple(x.shape), str(x.dtype).removeprefix("torch.")) for x in leaves]
    assert got == want
