"""Run one cell of the port's benchmark once, and print its result.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics are found by
name from ``BENCHMARK.json`` at the root of the checkout (see
``harness/spec.py``).  With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from a
profile of the first ``trace_seconds`` of the window.  Either way the run
checks what the window produced against the configuration's plain
reference (``reference/lm.py``, or the module its file names) and prints
each number compared beside its limit.

The run refuses to start without as many CUDA devices as the cell asks
for, and refuses to print a result if JAX or the JAX package ``repro`` is
loaded once the check and the metric readers have run.  It writes its
corpus under ``TMPDIR`` and keeps the kernels' build and the modules'
bytecode inside the checkout (``build/``).
"""
from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def main(argv=None, device=None, root: Path = ROOT, bench: Path = BENCH) -> int:
    """``device``: run on it and skip the look for the cell's cards (the
    benchmark's own tests drive the harness on the CPU so); ``root`` holds
    ``BENCHMARK.json`` and ``bench`` the mixes, limits and readers."""
    args = _args(argv)
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "bench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    from harness import common, spec

    cell = spec.load(args.workload, root, bench)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}",
                  file=sys.stderr)
            return 2
        from repro_torch.device import resolve_device

        device = resolve_device("cuda:0")
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the context and allocator, before any memory stats
    gen = importlib.import_module(f"harness.{cell.generator}")
    out = gen.run(cell, args.seed, args.seconds, bool(args.trace), device)

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if args.trace:
        run = out["run"]
        for m in cell.per_layer:
            value = spec.reader(m["name"], bench)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    card = _power_limit() if device.type == "cuda" else "cpu"
    result = {
        "correct": all(c["ok"] for c in out["checks"]),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": out["memory_peak_bytes"],
            "name_and_power_limit": card,
        },
    }
    trace = out["run"].get("trace")
    if args.trace and trace is not None:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_ops(10), "idle_gaps": trace.idle_gaps(10)}
    print(f"card: {card}; setup_s {out['setup_s']!r}; set-up phases (s): "
          f"{out['setup_phases']}", file=sys.stderr)
    # last, after the check and the readers: whatever the run loaded counts
    forbidden = common.forbidden_modules()
    if forbidden:
        print(f"loaded in the run: {forbidden} (JAX or the JAX package); no result",
              file=sys.stderr)
        return 3
    common.emit(result, out["checks"])
    return 0


if __name__ == "__main__":
    # the bytecode of every module the run imports, torch's too, cached in
    # the checkout at a fixed path: the first run there compiles it, later
    # runs read it
    sys.pycache_prefix = str(ROOT / "build" / "bench-cache" / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
