"""Pieces every generator shares: the checks' arithmetic, the import guard,
and the result's line."""
from __future__ import annotations

import json
import math
import statistics
import sys
import time
from typing import Dict, Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Phases:
    """Seconds of each named stage of set-up, from one stage's end to the
    next's, for the run's standard error."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self._t, 3)
        self._t = now


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   keep: Optional[Iterable[str]] = None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, as a share of the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    names = list(keep if keep is not None else reference)
    med = statistics.median(reference[k] for k in names)
    return max(abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in names)


def nearest_rank(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (``inf`` counts as a miss)."""
    xs = sorted(values)
    k = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
    return xs[k]


def check(name: str, value: float, limit: float) -> Dict:
    return {"name": name, "value": value, "limit": limit, "ok": bool(value <= limit)}


def emit(result: Dict, checks: List[Dict]) -> None:
    """Print every number compared beside its limit as the last lines of
    standard error, then the result as the last line of standard output,
    its ``checks`` key last."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(line), flush=True)
