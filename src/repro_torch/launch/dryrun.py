"""Multi-pod dry run: trace one step of every (arch × shape × mesh) cell
over the production mesh and read the roofline terms from the trace.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --set attn_impl=blocked --variant blocked

The port of ``repro.launch.dryrun``.  For each cell the ``input_specs``
tensors (on the meta device: nothing is allocated) are laid out as
DTensors on the fake 256- or 512-rank mesh (``launch.mesh.
make_production_mesh``) by the spec rules (``sharding.specs``), and one
train, prefill or decode step runs under ``comm_stats.Recorder``, which
sees what rank 0 would run: the FLOPs of every op, scaled to one device,
the bytes of the local ops, the collectives DTensor issues with their
local shapes and group sizes, and the live local bytes.  The kernels (K4,
K5, K6) report their own FLOPs and bytes from their meta path.

Measurement methodology
-----------------------
JAX lowers and compiles; XLA's cost analysis counts a scanned loop body
once, so the JAX dry run compiles unrolled probes and extrapolates, and
adds the sLSTM's and the rolled mLSTM chunks' FLOPs analytically.  The
port's model is a Python loop over layers, over the sLSTM's time steps
and over the mLSTM's chunks, so the trace holds every layer, step and
chunk as it runs: no probe, no extrapolation and no analytic addition is
needed, and none is made.  ``trace_s`` (the trace's seconds) takes the
place of JAX's ``lower_s``/``compile_s``.  The bytes are unfused, per
aten op; XLA's ``bytes accessed`` is of fused HLO, so the memory terms of
the two dry runs do not compare.

The roofline constants are one H100's (NVIDIA's data sheet, SXM part,
dense rates), at the full 700 W power limit.  Results are cached
incrementally in ``build/repro_torch/dryrun.json`` (or ``--out``) keyed
by (arch, shape, mesh, strategy, variant); re-runs skip completed cells
unless ``--force``.  The fake process group starts in ``main``.  With
``--all`` (narrowed by ``--arch`` or ``--shape``) each cell runs in a
fresh process, as many side by side as there are CPUs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.configs import SHAPES, all_cells, cell_is_runnable, get_config

RESULTS = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun.json"

# H100 SXM 80 GB, 700 W (the power limit nvidia-smi reports at full power)
PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
# H100 SXM 80 GB, 700 W: HBM3
HBM_BW = 3.35e12
# H100 SXM 80 GB, 700 W: NVLink 4, one direction of 900 GB/s
LINK_BW = 450e9

# archs whose default strategy is plain TP (small enough to replicate over data)
TP_ONLY = {"whisper-tiny"}


def apply_overrides(cfg, overrides):
    for kv in overrides or []:
        key, val = kv.split("=", 1)
        if val in ("true", "True"):
            val = True
        elif val in ("false", "False"):
            val = False
        else:
            try:
                val = int(val)
            except ValueError:
                try:
                    val = float(val)
                except ValueError:
                    pass
        if key.startswith("moe."):
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **{key[4:]: val}))
        else:
            cfg = cfg.replace(**{key: val})
    return cfg


def measure(cfg, shape_name, mesh, strategy):
    """Trace one step of the cell on ``mesh``; return the per-device
    costs."""
    from repro_torch.launch.comm_stats import Recorder, collective_stats, local_bytes
    from repro_torch.launch.input_specs import input_specs
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.layers.common import ShardCtx
    from repro_torch.sharding.specs import (
        batch_pspecs,
        cache_pspecs,
        distribute_tree,
        param_pspecs,
        state_pspecs,
    )
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step

    nchips = mesh.size()
    dp = dp_axes(mesh)
    ctx = ShardCtx(mesh=mesh, dp=dp)
    opt = AdamW()
    kind, specs = input_specs(cfg, shape_name, opt)
    rec = Recorder()
    t0 = time.time()
    if kind == "train":
        state, batch = specs
        state = distribute_tree(state, state_pspecs(cfg, state, mesh, strategy), mesh)
        batch = distribute_tree(batch, batch_pspecs(batch, mesh, dp), mesh)
        args = (state, batch)
        with rec:
            _, out = make_train_step(cfg, opt, ctx)(state, batch)
        aliased = local_bytes(state)  # the step updates the state in place
    else:
        params = distribute_tree(specs[0], param_pspecs(cfg, specs[0], mesh, strategy), mesh)
        if kind == "prefill":
            _, tokens, extras = specs
            cache = None
        else:
            _, cache, tokens, extras = specs
            cache = distribute_tree(cache, cache_pspecs(cache, mesh, dp), mesh)
        tokens = distribute_tree({"t": tokens}, batch_pspecs({"t": tokens}, mesh, dp), mesh)["t"]
        extras = distribute_tree(extras, batch_pspecs(extras, mesh, dp), mesh)
        with rec:
            if kind == "prefill":
                args = (params, tokens, extras)
                out = make_prefill_step(cfg, ctx)(params, tokens, extras)
            else:
                args = (params, cache, tokens, extras)
                out = make_decode_step(cfg, ctx)(params, cache, tokens, extras)
        aliased = local_bytes(cache) if cache is not None else 0  # updated in place
    t_trace = time.time() - t0
    colls = collective_stats(rec.records, nchips)
    arg_bytes = local_bytes(args)
    out_bytes = local_bytes(out)
    return {
        "kind": kind,
        "flops": rec.flops,
        "bytes": rec.bytes,
        "coll_wire": colls.per_device_bytes,
        "coll_raw": colls.raw_bytes,
        "coll_count": colls.count,
        "coll_by_kind": dict(colls.by_kind),
        "mem": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": rec.peak,
            "peak_bytes": arg_bytes + rec.peak,
            "alias_bytes": aliased,
        },
        "t_trace": t_trace,
        "trace": rec.trace,
    }


def run_cell(arch, shape_name, mesh_kind, strategy=None, overrides=None,
             variant="baseline", keep_trace=False, out_path=None):
    from repro_torch.launch.comm_stats import op_histogram
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as M

    cfg = apply_overrides(get_config(arch), overrides)
    strategy = strategy or ("tp" if arch in TP_ONLY else "fsdp_tp")
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    nchips = mesh.size()

    full = measure(cfg, shape_name, mesh, strategy)
    flops_dev = full["flops"]
    bytes_dev = full["bytes"]
    coll_dev = full["coll_wire"]

    n_params = M.param_count(cfg)
    n_active = M.param_count(cfg, active_only=True)
    sh = SHAPES[shape_name]
    kind = full["kind"]
    tokens = sh["global_batch"] * (sh["seq_len"] if kind != "decode" else 1)
    model_flops = 6.0 * n_active * tokens if kind == "train" else 2.0 * n_active * tokens

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "strategy": strategy,
        "variant": variant,
        "kind": kind,
        "chips": int(nchips),
        "status": "ok",
        "trace_s": round(full["t_trace"], 2),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_per_device_bytes": coll_dev,
        "collective_raw_bytes": full["coll_raw"],
        "collective_count": full["coll_count"],
        "collective_by_kind": full["coll_by_kind"],
        "memory": full["mem"],
        "roofline": {
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "dominant": dominant,
        },
        "model": {
            "params": n_params,
            "active_params": n_active,
            "model_flops_global": model_flops,
            "traced_flops_global": flops_dev * nchips,
            "useful_flops_ratio": model_flops / max(flops_dev * nchips, 1.0),
        },
        "overrides": list(overrides or []),
    }
    if keep_trace:
        tdir = Path(out_path or RESULTS).parent / "trace"
        tdir.mkdir(parents=True, exist_ok=True)
        fname = f"{arch}_{shape_name}_{mesh_kind}_{variant}.trace.txt"
        (tdir / fname).write_text("\n".join(full["trace"]) + "\n")
        result["trace_path"] = str(tdir / fname)
        result["op_histogram"] = {
            k: v
            for k, v in sorted(op_histogram(full["trace"]).items(), key=lambda kv: -kv[1])[:40]
        }
    return result


def cell_key(arch, shape, mesh_kind, strategy, variant):
    return f"{arch}|{shape}|{mesh_kind}|{strategy}|{variant}"


def load_results(path: Path):
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_results(res, path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(res, indent=1, sort_keys=True))
    tmp.replace(path)


def _run_apart(args, arch, shape, mk, out_path: Path):
    """One cell in a fresh process (a DTensor trace leaves caches behind
    and the dry run is single threaded); its record, or an error record
    with the end of its output."""
    part = out_path.with_name(f".{arch}_{shape}_{mk}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mk, "--variant", args.variant, "--out", str(part), "--force"]
    cmd += ["--strategy", args.strategy] if args.strategy else []
    cmd += [f"--set={o}" for o in args.overrides] + (["--keep-trace"] if args.keep_trace else [])
    run = subprocess.run(cmd, capture_output=True, text=True)
    recs = load_results(part)
    part.unlink(missing_ok=True)
    if recs:
        return next(iter(recs.values()))
    return {"status": "error", "error": f"exit {run.returncode}: {run.stderr[-2000:]}"}


def _run_here(args, arch, shape, mk, out_path: Path):
    try:
        return run_cell(arch, shape, mk, args.strategy, args.overrides, args.variant,
                        args.keep_trace, out_path)
    except Exception as e:  # noqa: BLE001 — record failures as data
        return {"status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def _record(results, cell, r, args, out_path: Path) -> bool:
    """Print and save one cell's record; True if it failed."""
    arch, shape, mk, key = cell
    if r["status"] == "ok":
        rl = r["roofline"]
        print(f"[ok] {key}: trace={r['trace_s']:.1f}s dominant={rl['dominant']} "
              f"compute={rl['t_compute_s']:.4f}s memory={rl['t_memory_s']:.4f}s "
              f"collective={rl['t_collective_s']:.4f}s "
              f"useful={r['model']['useful_flops_ratio']:.3f} "
              f"peak={r['memory']['peak_bytes']/1e9:.2f}GB", flush=True)
    else:
        r = {"arch": arch, "shape": shape, "mesh": mk, "strategy": key.split("|")[3],
             "variant": args.variant, **r}
        print(f"[FAILED] {key}: {r['error'][:2000]}", flush=True)
    results[key] = r
    save_results(results, out_path)
    return r["status"] != "ok"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell (of --arch and --shape where given), each in "
                         "a fresh process, as many side by side as there are CPUs")
    ap.add_argument("--strategy", default=None, choices=[None, "tp", "fsdp_tp"])
    ap.add_argument("--set", dest="overrides", action="append", default=[])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--keep-trace", action="store_true",
                    help="write each cell's dispatch trace beside the results")
    ap.add_argument("--out", default=None, help=f"results file (default {RESULTS})")
    args = ap.parse_args(argv)

    out_path = Path(args.out) if args.out else RESULTS
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a, s in all_cells()
                 if args.arch in (None, a) and args.shape in (None, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        if not cell_is_runnable(args.arch, args.shape):
            ap.error(f"cell ({args.arch},{args.shape}) is not runnable "
                     "(long_500k needs sub-quadratic sequence mixing)")
        cells = [(args.arch, args.shape)]

    results = load_results(out_path)
    work = []
    for arch, shape in cells:
        for mk in meshes:
            strategy = args.strategy or ("tp" if arch in TP_ONLY else "fsdp_tp")
            key = cell_key(arch, shape, mk, strategy, args.variant)
            if not args.force and results.get(key, {}).get("status") == "ok":
                print(f"[skip cached] {key}")
                continue
            work.append((arch, shape, mk, key))
    if args.all:
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            futures = [pool.submit(_run_apart, args, *w[:3], out_path) for w in work]
            failures = sum(_record(results, w, f.result(), args, out_path)
                           for w, f in zip(work, futures))
    else:
        from repro_torch.launch.mesh import _fake_group

        _fake_group()  # the 512-rank fake group both production meshes use
        failures = sum(_record(results, w, _run_here(args, *w[:3], out_path), args, out_path)
                       for w in work)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
