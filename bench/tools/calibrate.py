"""Readings that a cell's output limits are set from, many seeds in one
process on the card:

    python3 bench/tools/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 10 [--out FILE]

For every seed, one whole run of the cell (``--seconds`` of window) and the
numbers its check compares: the program's lower readings.  For every
control seed, besides: the control, the reference computed with its
products in float8 (e4m3) in the program's place, read against the float32
reference on the same inputs; and, for a training cell, the fault of a loss
taken over half of each sequence's tokens (batch 1 has no half of a batch
to leave out).  Each of those is held as the program is held: a MoE
configuration's float32 reference routes by that side's own routes
(``train.side_readings``).  One JSON line a reading, on standard output
and in ``--out``.  A configuration's limits are read before its cell is
kept: in a scratch checkout whose ``BENCHMARK.json`` holds the cell, with
a limits file of trial values.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def main(argv=None, device=None, root: Path = ROOT, bench: Path = BENCH) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--detail", action="store_true",
                    help="training: also every step's and leaf's gap, program and control")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import importlib

    import torch

    from harness import spec

    cell = spec.load(args.workload, root, bench)
    if device is None:
        from repro_torch.device import resolve_device

        device = resolve_device("cuda:0")
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
    gen = importlib.import_module(f"harness.{cell.generator}")
    out_f = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=cell.name))
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()

    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = gen.run(cell, seed, args.seconds, False, device)
        emit({"seed": seed, "side": "program", "correct": all(c["ok"] for c in out["checks"]),
              **{c["name"]: c["value"] for c in out["checks"]},
              **out["end_to_end"], "setup_s": out["setup_s"]})
        if seed not in controls:
            continue
        if cell.generator == "train":
            ids = out["check_ids"]
            if args.detail:
                ref = gen.reference_readings(cell, seed, device, ids,
                                             routes=out["program"].get("routes"))
                emit({"seed": seed, "side": "program_detail",
                      **gen.leaf_gaps(out["program"], ref)})
            for side, kw in (("control_fp8", {"precision": "fp8"}),
                             ("fault_half_tokens", {"loss_tokens": 0.5})):
                other, base = gen.side_readings(cell, seed, device, ids, **kw)
                emit({"seed": seed, "side": side, **gen.gaps(other, base)})
                if args.detail:
                    emit({"seed": seed, "side": side + "_detail", **gen.leaf_gaps(other, base)})
        else:
            gap = gen.widest_gap(cell, seed, device, out["requests"], out["served"], "fp8")
            emit({"seed": seed, "side": "control_fp8", "served_logit_gap": gap})
    if out_f:
        out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
