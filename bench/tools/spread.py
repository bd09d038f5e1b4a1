"""Spreads of two sets of runs, as the benchmark's bounds are set from them:
for each metric and set, the median and the distance between the first and
third quartile (``statistics.quantiles(values, n=4)``) as a share of the
median.

    python3 bench/tools/spread.py <dir holding <cell>.set<1|2>.<seed>.out files>
"""
import collections
import json
import statistics
import sys
from pathlib import Path


def main(folder: str) -> None:
    runs = collections.defaultdict(lambda: collections.defaultdict(list))
    for f in sorted(Path(folder).glob("*.set*.*.out")):
        cell, rest = f.name.split(".set", 1)
        lines = f.read_text().strip().splitlines()
        if not lines:
            print(f"{f.name}: no result")
            continue
        r = json.loads(lines[-1])
        runs[cell][rest.split(".", 1)[0]].append(r)
        if not r["correct"]:
            print(f"{f.name}: correct false {r['checks']}")
    for cell, sets in runs.items():
        for s, rs in sorted(sets.items()):
            for m in rs[0]["metrics"]:
                v = [r["metrics"][m]["value"] for r in rs]
                med = statistics.median(v)
                q = statistics.quantiles(v, n=4) if len(v) > 1 else [med, med, med]
                print(f"{cell} set {s} {m}: n {len(v)} median {med!r} spread {(q[2] - q[0]) / med!r} "
                      f"values {v}")


if __name__ == "__main__":
    main(sys.argv[1])
