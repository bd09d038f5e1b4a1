"""Process bodies of the port's multi-rank CPU tests (gradient
compression, the SPMD layout).

Spawned processes import this module by name, so it imports only torch
and the port (no JAX, no test module): a rank joins a gloo group through
a shared file, runs its cases and puts ``(rank, outputs)`` on a queue.
"""
import multiprocessing


def _compressed_psum_rank(rank, world, init_file, cases, out_q):
    import torch
    import torch.distributed as dist

    from repro_torch.train.compression import compressed_psum

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        outs = [compressed_psum(torch.from_numpy(x[rank]), bits=bits).numpy()
                for x, bits in cases]
        out_q.put((rank, outs))
    finally:
        dist.destroy_process_group()


def _spmd_step_rank(rank, world, init_file, cases, out_q):
    """Smoke-model cases (``case["arch"]``) on a (2, 2) ``("data",
    "model")`` mesh over ``world`` = 4 gloo ranks: the state laid out by
    ``state_pspecs``, one train step; with ``decode_steps``, the initial
    parameters laid out by ``param_pspecs``, a prefill, then
    teacher-forced decode steps from an empty cache laid out by
    ``cache_pspecs``.  Every output is gathered whole (numpy).  A case
    with ``shard_vocab_embed`` is an embedding case (``_embed_case``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import dp_axes, make_host_mesh
    from repro_torch.layers.common import ShardCtx
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import (batch_pspecs, cache_pspecs, distribute_tree,
                                            param_pspecs, state_pspecs)
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step
    from repro_torch.utils.tree import tree_map

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_host_mesh(2, 2, device="cpu")
        dp = dp_axes(mesh)
        ctx = ShardCtx(mesh, dp)
        whole = lambda t: t.full_tensor().numpy()  # noqa: E731
        outs = []
        for case in cases:
            if "shard_vocab_embed" in case:
                outs.append(_embed_case(mesh, case))
                continue
            cfg = get_config(case["arch"], smoke=True).replace(**case["cfg"])
            params = lambda: tree_map(lambda a: torch.from_numpy(a.copy()), case["params"])  # noqa: E731
            opt = AdamW()
            p0 = params()
            state = {"params": p0, "opt": opt.init(p0),
                     "step": torch.zeros((), dtype=torch.int32)}
            state = distribute_tree(state, state_pspecs(cfg, state, mesh, "fsdp_tp"), mesh)
            batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
            batch = distribute_tree(batch, batch_pspecs(batch, mesh, dp), mesh)
            state, out = make_train_step(cfg, opt, ctx,
                                         microbatches=case.get("microbatches", 1))(state, batch)
            res = {"loss": whole(out["loss"]), "params": tree_map(whole, state["params"]),
                   "mu": tree_map(whole, state["opt"]["mu"])}
            if not case.get("decode_steps"):
                outs.append(res)
                continue
            p = params()
            p = distribute_tree(p, param_pspecs(cfg, p, mesh, "fsdp_tp"), mesh)
            toks = {"t": torch.from_numpy(case["prompt"])}
            toks = distribute_tree(toks, batch_pspecs(toks, mesh, dp), mesh)["t"]
            _, logits = make_prefill_step(cfg, ctx)(p, toks)
            res["prefill"] = whole(logits)
            b, s = case["prompt"].shape
            cache = M.init_decode_cache(cfg, b, s, torch.device("cpu"))
            cache = distribute_tree(cache, cache_pspecs(cache, mesh, dp), mesh)
            decode, res["decode"] = make_decode_step(cfg, ctx), []
            for i in range(case["decode_steps"]):
                tok = {"t": torch.from_numpy(case["prompt"][:, i:i + 1].copy())}
                tok = distribute_tree(tok, batch_pspecs(tok, mesh, dp), mesh)["t"]
                cache, logits = decode(p, cache, tok)
                res["decode"].append(whole(logits))
            outs.append(res)
        out_q.put((rank, outs))
    finally:
        dist.destroy_process_group()


def _embed_case(mesh, case):
    """The embedding gather on ``mesh``: the table ``w`` (V, d) laid out by
    ``param_pspecs`` (``case["shard_vocab_embed"]``) and ids ``(B, S)`` by
    ``batch_pspecs``, ``model._embed`` forward, then ``(rows * g).sum()``
    backward for an upstream gradient ``g``.  Returns the rows, the
    table's gradient (both whole) and the table's spec."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import batch_pspecs, distribute_tree, param_pspecs

    cfg = get_config("granite-3-8b", smoke=True).replace(
        dtype="float32", shard_vocab_embed=case["shard_vocab_embed"])
    params = {"embed": torch.from_numpy(case["w"].copy())}
    spec = param_pspecs(cfg, params, mesh)
    params = distribute_tree(params, spec, mesh)
    w = params["embed"].detach().requires_grad_()
    ids = {"t": torch.from_numpy(case["ids"])}
    ids = distribute_tree(ids, batch_pspecs(ids, mesh, dp_axes(mesh)), mesh)["t"]
    rows = M._embed(cfg, {"embed": w}, ids)
    g = DTensor.from_local(torch.from_numpy(case["g"]), mesh, [Replicate()] * 2, run_check=False)
    (rows * g).sum().backward()
    return {"rows": rows.detach().full_tensor().numpy(), "grad": w.grad.full_tensor().numpy(),
            "spec": spec["embed"]}


def run_ranks(world, init_file, cases, timeout_s=60.0, target=_compressed_psum_rank):
    """Run ``target`` (``compressed_psum`` over ``cases``, ``[(x, bits)]``,
    ``x`` of shape ``(world, ...)``, row ``r`` on rank ``r``, by default)
    in ``world`` spawned gloo ranks.  Returns ``{rank: [output, ...]}``; a
    rank that does not answer within ``timeout_s`` is killed and raises
    ``TimeoutError``."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world, init_file, cases, q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(world):
            rank, outs = q.get(timeout=timeout_s)
            out[rank] = outs
    except Exception as e:
        raise TimeoutError(f"only ranks {sorted(out)} of {world} answered") from e
    finally:
        for p in procs:
            p.join(timeout=timeout_s)
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}")
    return out


def mesh_echo(spec, rounds):
    """A CPU-mesh host: ``rounds`` all_gather rounds, each checked."""
    for r in range(rounds):
        got = spec.all_gather((spec.host_id, r))
        assert got == {h: (h, r) for h in range(spec.num_hosts)}, got


def mesh_raise(spec):
    """A CPU mesh whose last host dies before the first round."""
    if spec.host_id == spec.num_hosts - 1:
        raise SystemExit(3)
    spec.all_gather(spec.host_id)
