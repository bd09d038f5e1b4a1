"""Process bodies of the port's multi-rank CPU tests.

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


def run_ranks(world, init_file, cases, timeout_s=60.0):
    """Run ``compressed_psum`` over ``cases`` (``[(x, bits)]``, ``x`` of
    shape ``(world, ...)``, row ``r`` on rank ``r``) in ``world`` spawned
    gloo ranks.  Returns ``{rank: [output, ...]}``; a rank that does not
    answer within ``timeout_s`` is killed and raises ``TimeoutError``."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_compressed_psum_rank, args=(r, world, init_file, cases, q),
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
