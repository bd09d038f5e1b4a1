"""The port's SPMD layout against the unsharded port and JAX, on the CPU.

granite-3-8b's smoke model in float32 on 4 gloo ranks as a (2, 2)
``("data", "model")`` mesh (``tests/_torch_dist.py``): the state, batch
and cache laid out as DTensors by the port's spec rules, with
``sequence_parallel`` off and on in training (on: two microbatches);
recurrentgemma-2b's smoke model in float32 on the same mesh (K5 with
the RG-LRU width split over ``model``, the block-diagonal gates, the
local-attention ring: a prefill of 32 tokens and teacher-forced decode
20 steps from an empty ring of 16 slots, so past the window, with the
ring's slots split over ``model`` and K6 combining the two halves); and
one train step of xlstm-1.3b's smoke model (the sLSTM's recurrence runs
per row on each rank: its weights' gradient is a partial sum over the
data ranks), whose gradients are read from AdamW's first moments (its first update divides
by |g|, which turns a 1e-7 relative change in a near-zero gradient into
a change of the update's sign bit).  Tolerances:
  * one train step's loss: 1e-6 relative to the unsharded port step's
    (the sharded products sum in another order) and 1e-5 to JAX's
    ``loss_fn`` on the same weights and batch;
  * the updated parameters (granite, recurrentgemma), the first moments
    (xlstm): 1e-5 of each leaf's largest entry;
  * prefill and teacher-forced decode logits: 2e-5 (the ``TOL`` of f32).
Also: the ``local_map`` route of K4, K5 and K6 on a one-rank CPU mesh
(the ``remat="dots"`` train step on meta DTensors runs in
``tests/test_torch_dryrun.py``).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_dist import _spmd_step_rank, run_ranks
from repro.configs.granite_3_8b import smoke_config as jax_granite
from repro.models import model as jm
from repro_torch.configs.granite_3_8b import smoke_config as torch_granite
from repro_torch.kernels import ops
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax
from repro_torch.train.optimizer import AdamW
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_map

B, S, PROMPT, DECODE = 4, 16, 12, 3
RG_PROMPT, RG_DECODE = 32, 20  # recurrentgemma smoke: a window of 16


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def case():
    jcfg = jax_granite().replace(dtype="float32")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    prompt = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jloss, _ = jm.loss_fn(jcfg, jparams, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    return {"params": tree_map(lambda t: t.numpy(), params), "batch": batch,
            "prompt": prompt, "jax_loss": float(jloss)}


def _plain(cfg, case, microbatches=1, decode_steps=DECODE):
    """The unsharded port: one train step, a prefill of ``case["prompt"]``,
    ``decode_steps`` teacher-forced decode steps from an empty cache."""
    fresh = lambda: tree_map(lambda a: torch.from_numpy(a.copy()), case["params"])  # noqa: E731
    opt = AdamW()
    p = fresh()
    state = {"params": p, "opt": opt.init(p), "step": torch.zeros((), dtype=torch.int32)}
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    state, out = make_train_step(cfg, opt, microbatches=microbatches)(state, batch)
    res = {"loss": out["loss"].numpy(), "params": tree_map(lambda t: t.numpy(), state["params"]),
           "mu": tree_map(lambda t: t.numpy(), state["opt"]["mu"])}
    p = fresh()
    _, logits = make_prefill_step(cfg)(p, torch.from_numpy(case["prompt"]))
    res["prefill"] = logits.numpy()
    cache = tm.init_decode_cache(cfg, B, case["prompt"].shape[1], torch.device("cpu"))
    decode, res["decode"] = make_decode_step(cfg), []
    for i in range(decode_steps):
        cache, logits = decode(p, cache, torch.from_numpy(case["prompt"][:, i:i + 1].copy()))
        res["decode"].append(logits.numpy())
    return res


def _xlstm_case():
    from repro_torch.configs import get_config

    cfg = get_config("xlstm-1.3b", smoke=True).replace(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    return {"arch": "xlstm-1.3b", "cfg": {"dtype": "float32"},
            "params": tree_map(lambda t: t.numpy(), params), "batch": batch}


def _recurrentgemma_case():
    from repro_torch.configs import get_config

    cfg = get_config("recurrentgemma-2b", smoke=True).replace(dtype="float32")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    prompt = rng.integers(0, cfg.vocab_size, (B, RG_PROMPT)).astype(np.int32)
    return {"arch": "recurrentgemma-2b", "cfg": {"dtype": "float32"},
            "params": tree_map(lambda t: t.numpy(), params), "batch": batch,
            "prompt": prompt, "decode_steps": RG_DECODE}


@pytest.fixture(scope="module")
def sharded(case, tmp_path_factory):
    # sequence_parallel lays out training's residual only: prefill and
    # decode run with it off; its step also splits the batch into two
    # microbatches
    cases = [dict(case, arch="granite-3-8b", cfg={"dtype": "float32", "sequence_parallel": sp},
                  decode_steps=0 if sp else DECODE, microbatches=2 if sp else 1)
             for sp in (False, True)]
    cases += [_xlstm_case(), _recurrentgemma_case()]
    init = tmp_path_factory.mktemp("spmd") / "init"
    out = run_ranks(4, str(init), cases, timeout_s=180.0, target=_spmd_step_rank)
    return dict(zip((False, True, "xlstm", "recurrentgemma"), out[0]),
                xlstm_case=cases[2], rg_case=cases[3])


@pytest.mark.parametrize("sp", [False, True], ids=["no_sp", "sequence_parallel"])
def test_sharded_train_step_matches_unsharded_and_jax(case, sharded, sp):
    """With ``sequence_parallel``, also two microbatches: the loss is
    their mean, as JAX's microbatched step takes it, which the masked
    labels move off JAX's ``loss_fn`` over the whole batch, so that one
    is held against the unsharded port only."""
    cfg = torch_granite().replace(dtype="float32", sequence_parallel=sp)
    plain, got = _plain(cfg, case, microbatches=2 if sp else 1), sharded[sp]
    _close(got["loss"], plain["loss"], 1e-6)
    if not sp:
        _close(got["loss"], case["jax_loss"], 1e-5)
    for g, w in zip(tree_leaves(got["params"]), tree_leaves(plain["params"])):
        _close(g, w, 1e-5)


def test_sharded_xlstm_train_step_matches_unsharded(sharded):
    from repro_torch.configs import get_config

    xcase = sharded["xlstm_case"]
    cfg = get_config("xlstm-1.3b", smoke=True).replace(dtype="float32")
    p = tree_map(lambda a: torch.from_numpy(a.copy()), xcase["params"])
    opt = AdamW()
    state = {"params": p, "opt": opt.init(p), "step": torch.zeros((), dtype=torch.int32)}
    state, out = make_train_step(cfg, opt)(
        state, {k: torch.from_numpy(v) for k, v in xcase["batch"].items()})
    got = sharded["xlstm"]
    _close(got["loss"], out["loss"].numpy(), 1e-6)
    for g, w in zip(tree_leaves(got["mu"]), tree_leaves(state["opt"]["mu"])):
        _close(g, w.numpy(), 1e-5)


def test_sharded_prefill_and_decode_match_unsharded(case, sharded):
    cfg = torch_granite().replace(dtype="float32")
    plain, got = _plain(cfg, case), sharded[False]
    _close(got["prefill"], plain["prefill"], 2e-5)
    assert len(got["decode"]) == DECODE
    for g, w in zip(got["decode"], plain["decode"]):
        _close(g, w, 2e-5)


def test_sharded_recurrentgemma_matches_unsharded(sharded):
    """One train step (its gradients read from the first moments, as
    xlstm's: AdamW's first update is lr·g/(|g| + 1e-8), so where a
    gradient is near 1e-8 the sum order's rounding moves the update by
    3e-3 of itself), the prefill and decode past the local window."""
    from repro_torch.configs import get_config

    cfg = get_config("recurrentgemma-2b", smoke=True).replace(dtype="float32")
    plain, got = _plain(cfg, sharded["rg_case"], decode_steps=RG_DECODE), sharded["recurrentgemma"]
    _close(got["loss"], plain["loss"], 1e-6)
    for g, w in zip(tree_leaves(got["mu"]), tree_leaves(plain["mu"])):
        _close(g, w, 1e-5)
    _close(got["prefill"], plain["prefill"], 2e-5)
    assert len(got["decode"]) == RG_DECODE
    for g, w in zip(got["decode"], plain["decode"]):
        _close(g, w, 2e-5)


@pytest.fixture
def one_rank_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if dist.is_initialized():
        pytest.fail("a process group is up already")
    mesh = make_host_mesh(1, 1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_kernels_take_dtensors_through_local_map(one_rank_mesh):
    """K4, K6 and K5 (and its backward) on DTensors give the plain
    tensors' results, through the local route."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, h, 16, generator=g) for h in (4, 2, 2))
    cur = torch.tensor([3, 7], dtype=torch.int32)
    a = torch.rand(2, 8, 12, generator=g)
    x = torch.randn(2, 8, 12, generator=g)
    dt = lambda t: distribute_tensor(t, one_rank_mesh, [Replicate(), Replicate()])  # noqa: E731
    got = ops.flash_attention(dt(q), dt(k), dt(v))
    assert isinstance(got, DTensor)
    torch.testing.assert_close(got.full_tensor(), ops.flash_attention(q, k, v), rtol=0, atol=0)
    got = ops.flash_decode(dt(q[:, 0]), dt(k), dt(v), cur)
    torch.testing.assert_close(got.full_tensor(), ops.flash_decode(q[:, 0], k, v, cur),
                               rtol=0, atol=0)
    ad, xd = dt(a).requires_grad_(), dt(x).requires_grad_()
    ops.RGLRUScan.apply(ad, xd).sum().backward()
    a0, x0 = a.clone().requires_grad_(), x.clone().requires_grad_()
    want = ops.RGLRUScan.apply(a0, x0)
    want.sum().backward()
    torch.testing.assert_close(ops.RGLRUScan.apply(dt(a), dt(x)).full_tensor(), want.detach(),
                               rtol=0, atol=0)
    torch.testing.assert_close(ad.grad.full_tensor(), a0.grad, rtol=0, atol=0)
    torch.testing.assert_close(xd.grad.full_tensor(), x0.grad, rtol=0, atol=0)
