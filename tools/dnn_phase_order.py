#!/usr/bin/env python3
"""Does chip_smoke.py's DNN phase run slower after the phases placed
before it for the LM training path?

    python3 tools/dnn_phase_order.py [--order ABBA] [--out chiprun_out/dnn_order]

Each letter of ``--order`` is one fresh process on the card that builds
the kernels and runs ``chip_smoke.dnn_phase``:

- ``A``: the DNN phase alone;
- ``B``: first ``rglru_kernel_phase`` (the scan kernels checked and timed
  at (1, 4096, 2560)) and ``train_step_phase`` (one smoke recurrentgemma
  step on the card and on the CPU), as chip_smoke.py runs them before it.

Each run's full output goes to ``<out>/<i>_<letter>.log``; the script
prints, per run, the phase's seconds and its lines with steps/s and the
profiled busy share, then the median phase seconds of A and of B.
Needs one CUDA device; exits non-zero without one or if a run fails.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(kind: str) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    build.build()
    build.library()
    if kind == "B":
        chip_smoke.rglru_kernel_phase(dev)
        chip_smoke.train_step_phase(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chip_smoke.dnn_phase(dev)
    print(f"DNN phase {time.perf_counter() - t0:.3f} s")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--order", default="ABBA")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "dnn_order"))
    p.add_argument("--run", choices=("A", "B"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.run:
        return run_one(args.run)
    import torch

    if not torch.cuda.is_available():
        print("dnn_phase_order: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    os.makedirs(args.out, exist_ok=True)
    seconds = {"A": [], "B": []}
    for i, kind in enumerate(args.order):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", kind],
                              capture_output=True, text=True, timeout=900)
        log = os.path.join(args.out, f"{i}_{kind}.log")
        with open(log, "w") as f:
            f.write(proc.stdout + proc.stderr)
        m = re.search(r"^DNN phase ([0-9.]+) s$", proc.stdout, re.M)
        if proc.returncode or not m:
            print(f"run {i} ({kind}) failed with code {proc.returncode}; see {log}")
            print(proc.stderr[-4000:])
            return 1
        seconds[kind].append(float(m.group(1)))
        print(f"run {i} ({kind}): DNN phase {m.group(1)} s")
        for line in proc.stdout.splitlines():
            if "steps/s" in line or "busy share" in line or "epoch_order" in line:
                print("   ", line.strip()[:200])
    for kind, xs in seconds.items():
        if xs:
            print(f"{kind}: median DNN phase {statistics.median(xs):.3f} s over {len(xs)} runs "
                  f"({', '.join(f'{x:.3f}' for x in xs)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
