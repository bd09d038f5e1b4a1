"""The port's partition-spec rules (``repro_torch.sharding.specs``)
against the JAX package's, leaf for leaf, on fake meshes: no devices,
pure divisibility and shape logic.  The port's rules read the port's
meta-device trees; JAX's read ``eval_shape`` trees."""
import math
from functools import lru_cache
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.launch import input_specs as jspecs
from repro.sharding import specs as jsharding
from repro.utils.tree import path_str as jax_path_str
from repro_torch.configs import get_config
from repro_torch.launch import input_specs as tspecs
from repro_torch.sharding import specs as tsharding
from repro_torch.utils.tree import flatten_with_path, path_str

MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


def jax_mesh(name):
    shape, names = MESHES[name]
    return SimpleNamespace(axis_names=names, devices=SimpleNamespace(shape=shape,
                                                                     size=math.prod(shape)))


def torch_mesh(name):
    shape, names = MESHES[name]
    return SimpleNamespace(mesh_dim_names=names, shape=shape)


def _jax_by_path(specs):
    leaves = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax_path_str(p): tuple(s) for p, s in leaves}


def _torch_by_path(tree, specs):
    paths = [path_str(p) for p, _ in flatten_with_path(tree)]
    return dict(zip(paths, tsharding._spec_leaves(specs)))


@lru_cache(maxsize=None)
def _states(arch):
    return jspecs.state_specs(jax_config(arch)), tspecs.state_specs(get_config(arch))


@pytest.mark.parametrize("strategy", ["fsdp_tp", "tp"])
@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_pspecs_equal_jax(arch, mesh, strategy):
    jst, tst = _states(arch)
    want = _jax_by_path(jsharding.state_pspecs(jax_config(arch), jst, jax_mesh(mesh), strategy))
    got = _torch_by_path(tst, tsharding.state_pspecs(get_config(arch), tst, torch_mesh(mesh),
                                                     strategy))
    assert got == want


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "xlstm-1.3b", "recurrentgemma-2b"])
def test_cache_pspecs_equal_jax(arch, mesh):
    dp = ("pod", "data") if mesh == "multi" else ("data",)
    jc = jspecs.cache_specs(jax_config(arch), 128, 32768)
    tc = tspecs.cache_specs(get_config(arch), 128, 32768)
    want = _jax_by_path(jsharding.cache_pspecs(jc, jax_mesh(mesh), dp))
    got = _torch_by_path(tc, tsharding.cache_pspecs(tc, torch_mesh(mesh), dp))
    assert got == want


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,batch", [("granite-3-8b", 256), ("whisper-tiny", 3),
                                        ("qwen2-vl-72b", 32)])
def test_batch_pspecs_equal_jax(arch, batch, mesh):
    dp = ("pod", "data") if mesh == "multi" else ("data",)
    jb = jspecs.batch_specs(jax_config(arch), batch, 64)
    tb = tspecs.batch_specs(get_config(arch), batch, 64)
    want = _jax_by_path(jsharding.batch_pspecs(jb, jax_mesh(mesh), dp))
    got = _torch_by_path(tb, tsharding.batch_pspecs(tb, torch_mesh(mesh), dp))
    assert got == want


def test_placements_of_a_tuple_of_axes():
    from torch.distributed.tensor import Replicate, Shard

    mesh = torch_mesh("multi")
    assert tsharding.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert tsharding.placements(("data", None), mesh) == (Replicate(), Shard(0), Replicate())
    assert tsharding.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        tsharding.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="shards two tensor dims"):
        tsharding.placements(("model", "model"), mesh)


def test_distribute_tree_lays_out_each_leaf_by_its_spec():
    """``distribute_tree`` on meta tensors over a fake 4-rank mesh, in a
    fresh process (the fake group must not outlive the test)."""
    import os
    import subprocess
    import sys

    code = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.sharding.specs import distribute_tree
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
tree = {"a": torch.empty(8, 6, device="meta"), "b": [torch.empty((), device="meta")]}
out = distribute_tree(tree, {"a": ("data", "model"), "b": [()]}, mesh)
print(tuple(out["a"].to_local().shape), out["a"].placements, out["b"][0].placements)
"""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ("(4, 3) (Shard(dim=0), Shard(dim=1)) "
                                  "(Replicate(), Replicate())")


def test_map_with_path_gives_jax_paths():
    from repro_torch.utils.tree import map_with_path

    tree = {"stages": [({"attn": {"wq": torch.zeros(1)}},)], "embed": torch.zeros(1)}
    got = []
    map_with_path(lambda p, x: got.append(p), tree)
    assert got == ["stages/0/0/attn/wq", "embed"]
