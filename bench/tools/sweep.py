"""The serving cell's knee: the highest offered rate its system sustains.

    python3 bench/tools/sweep.py --workload <serving cell> --seed <n> \\
        --rates 1,1.5,2,... --seconds 30 [--out FILE]

One window a rate, open loop as the cell runs it, the mix's rate replaced
and no output check.  For each: requests due, their time to first token
(median and 90th percentile, ms; a request still waiting at the close
counts as a miss), the requests still waiting for a first token when the
window closes (a backlog that grows with the window means the rate is
past the knee), and served tokens a second.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from harness import common, serve, spec
    from repro_torch.device import resolve_device

    device = resolve_device("cuda:0")
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    cell = spec.load(args.workload, ROOT)
    for rate in [float(r) for r in args.rates.split(",")]:
        c = dataclasses.replace(cell, mix=dict(cell.mix, rate_per_s=rate, drain_seconds=0))
        out = serve.run(c, args.seed, args.seconds, False, device, check=False)
        ttft = out["ttft_ms"]
        served = sum(len(t) for t in out["served"].values())
        rec = {"rate_per_s": rate, "due": len(ttft), "waiting_at_close": out["waiting_at_close"],
               "ttft_ms_p50": common.nearest_rank(ttft, 50) if ttft else math.nan,
               "ttft_ms_p90": common.nearest_rank(ttft, 90) if ttft else math.nan,
               "tokens_per_s": served / out["run"]["window_s"],
               "decode_step_ms": 1e3 * out["run"]["decode_s"] / max(1, out["run"]["decode_steps"]),
               "prefill_ms": 1e3 * out["run"]["prefill_s"] / max(1, out["run"]["prefills"])}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
