"""``repro_torch.utils``'s tree counts against ``repro.utils``'s: the
entries and bytes of an ``init_params`` tree, JAX's and the same tree
carried into the port by ``params_from_jax``, for granite-3-8b's and
qwen2-moe-a2.7b's smoke configs with f32 and bf16 storage; and the
package's re-exports, name for name."""
import jax
import numpy as np
import pytest
import torch

import repro.utils as jax_utils
import repro_torch.utils as torch_utils
from repro.configs import get_config
from repro.models import model as jm
from repro_torch.models.weights import params_from_jax


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b"])
def test_tree_counts_equal_jax(arch, dtype):
    cfg = get_config(arch, smoke=True).replace(param_dtype=dtype)
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert {t.dtype for t in jax.tree_util.tree_leaves(tparams)} == {getattr(torch, dtype)}
    count = jax_utils.tree_param_count(jparams)
    nbytes = jax_utils.tree_bytes(jparams)
    assert nbytes == count * (4 if dtype == "float32" else 2)
    assert torch_utils.tree_param_count(tparams) == count
    assert torch_utils.tree_bytes(tparams) == nbytes
    # numpy leaves count the same
    npy = jax.tree_util.tree_map(np.asarray, jparams)
    assert torch_utils.tree_param_count(npy) == count
    assert torch_utils.tree_bytes(npy) == nbytes


def test_utils_reexports_what_jax_utils_does():
    names = {"map_with_path", "path_str", "tree_bytes", "tree_param_count"}
    for name in names:
        assert callable(getattr(jax_utils, name)) and callable(getattr(torch_utils, name))
    tree = {"b": [torch.zeros(2, 3), torch.zeros(4)], "a": torch.zeros(())}
    got = torch_utils.map_with_path(lambda p, x: p, tree)
    assert got == {"b": ["b/0", "b/1"], "a": "a"}
    assert torch_utils.path_str(("stages", 0, 1, "attn", "wq")) == "stages/0/1/attn/wq"
