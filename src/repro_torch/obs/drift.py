"""Model-vs-measured drift detection for the LIRS I/O stack.

The repo carries *closed forms* for how the clairvoyant tier must
behave (``repro_torch.storage.devices``): Belady's ``hit = c`` exactly, the
planner's ``(1 − hit)·n`` per-epoch storage-read floor, the
``distributed_hit_model`` local/remote/storage split, and Table 2 epoch
read pricing.  A live run that diverges from them is *broken* — a
planner regression, an admission leak, a placement bug — long before a
wall-clock benchmark notices.  This module turns each form into an
epoch-end check with a per-metric tolerance, producing a
:class:`DriftReport` that ``launch/train.py`` prints in its summary and
tests/benchmarks can assert on (:meth:`DriftReport.assert_ok`).

Tolerances mirror what the benchmark gate (``benchmarks/compare.py``)
already accepts today: hit rate 0.02 absolute under Belady (the model
is exact) and 0.05 under LRU (the closed form is asymptotic in ``n``);
per-epoch storage reads within 5 % of ``n`` (the epoch-edge window race
— the lookahead window straddles epoch boundaries, so up to roughly a
window of reads can migrate between adjacent epochs); tier-split
fractions 0.05 absolute; modeled epoch read time 10 % relative (both
sides are priced through the same :class:`StorageModel`, so only
read-count drift can separate them).

All report functions take plain numbers — measured counts come from
``IOStats.snapshot()`` deltas over the *steady* (warm) epochs, never
from the cold first epoch, which is all misses by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.storage.devices import (
    STORAGE_MODELS,
    StorageModel,
    block_cache_hit_model,
    cache_hit_model,
    distributed_hit_model,
    wasted_read_fraction,
)

# Per-metric tolerances (units in the name; see module docstring).
TOLERANCES: Dict[str, float] = {
    "hit_rate_abs_belady": 0.02,   # == compare.py's hit_rate kind
    "hit_rate_abs_lru": 0.05,      # LRU closed form is asymptotic
    # slack for the lru / planner-off paths (no closed-form floor);
    # the belady fleet floor itself is exact and gated at zero by
    # benchmarks/compare.py, not here
    "storage_reads_frac_of_n": 0.05,
    "split_abs": 0.05,             # distributed_hit_model fractions
    "epoch_read_rel": 0.10,        # Table 2 pricing of measured counts
}


def hit_rate_tolerance(policy: str) -> float:
    return TOLERANCES[
        "hit_rate_abs_belady" if policy == "belady" else "hit_rate_abs_lru"
    ]


@dataclass
class DriftCheck:
    """One model-vs-measured comparison.  ``ok`` iff the absolute error
    is within ``max(tol_abs, tol_rel · |expected|)``."""

    name: str
    measured: float
    expected: float
    tol_abs: float = 0.0
    tol_rel: float = 0.0
    note: str = ""

    @property
    def error(self) -> float:
        return self.measured - self.expected

    @property
    def slack(self) -> float:
        return max(self.tol_abs, self.tol_rel * abs(self.expected))

    @property
    def ok(self) -> bool:
        return abs(self.error) <= self.slack

    def to_dict(self) -> dict:
        return {
            "measured": self.measured,
            "expected": self.expected,
            "error": self.error,
            "slack": self.slack,
            "ok": self.ok,
            **({"note": self.note} if self.note else {}),
        }


@dataclass
class DriftReport:
    checks: List[DriftCheck] = field(default_factory=list)
    context: dict = field(default_factory=dict)

    def add(
        self,
        name: str,
        measured: float,
        expected: float,
        tol_abs: float = 0.0,
        tol_rel: float = 0.0,
        note: str = "",
    ) -> DriftCheck:
        c = DriftCheck(name, float(measured), float(expected), tol_abs,
                       tol_rel, note)
        self.checks.append(c)
        return c

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    @property
    def failed(self) -> List[DriftCheck]:
        return [c for c in self.checks if not c.ok]

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "context": dict(self.context),
            "checks": {c.name: c.to_dict() for c in self.checks},
        }

    def format(self) -> str:
        lines = [
            f"{'check':<34} {'measured':>12} {'expected':>12} "
            f"{'error':>10} {'slack':>9}  ok"
        ]
        for c in self.checks:
            lines.append(
                f"{c.name:<34} {c.measured:>12.4f} {c.expected:>12.4f} "
                f"{c.error:>+10.4f} {c.slack:>9.4f}  "
                f"{'yes' if c.ok else 'NO'}"
            )
        return "\n".join(lines)

    def assert_ok(self) -> "DriftReport":
        """Raise with the full table when any check drifted — the form
        tests and benchmarks use to gate on model agreement."""
        if not self.ok:
            names = ", ".join(c.name for c in self.failed)
            raise AssertionError(
                f"model-vs-measured drift beyond tolerance in [{names}]\n"
                + self.format()
            )
        return self


class _PlanShim:
    """Minimal IOPlan duck-type for :meth:`StorageModel.t_epoch_read`."""

    epoch_seq_read_bytes = 0.0
    cache_hit_fraction = 0.0
    preprocess_seq_read_bytes = 0.0
    preprocess_rand_write_ios = 0.0
    preprocess_rand_write_bytes = 0.0

    def __init__(self, ios: float, nbytes: float, queue_depth: float):
        self.epoch_rand_read_ios = ios
        self.epoch_rand_read_bytes = nbytes
        self.queue_depth = queue_depth


def _resolve_device(device) -> Optional[StorageModel]:
    if device is None:
        return None
    if isinstance(device, StorageModel):
        return device
    return STORAGE_MODELS[device]


def single_host_report(
    *,
    n_records: int,
    record_bytes: int,
    capacity_frac: float,
    policy: str,
    planner_on: bool,
    window_frac: float,
    batch_frac: float,
    epochs: int,
    storage_records: float,
    storage_ios: float = 0.0,
    storage_bytes: float = 0.0,
    device=None,
    queue_depth: float = 1.0,
    block_frac: float = 0.0,
    span_frac: float = 0.0,
) -> DriftReport:
    """Drift report for a single-host tiered run.

    Measured inputs are totals over ``epochs`` *steady* epochs (deltas
    of ``IOStats.snapshot()``): ``storage_records`` records actually
    read from storage, optionally ``storage_ios``/``storage_bytes`` for
    the Table 2 time check (``device`` one of ``hdd|ssd|optane`` or a
    :class:`StorageModel`).

    ``block_frac``/``span_frac`` make the expected hit rate
    strategy-aware: for a block shuffler (CorgiPile / Corgi²) pass its
    block and buffer-span fractions of ``n`` and the LRU expectation
    switches to the block-corrected closed form
    (:func:`repro_torch.storage.devices.block_cache_hit_model`); zero — the
    default — is the uniform-permutation (LIRS) form, and Belady is
    ``hit = c`` either way."""
    if epochs < 1:
        raise ValueError("need at least one steady epoch of measurements")
    r = DriftReport(context={
        "layer": "single_host",
        "n_records": n_records,
        "capacity_frac": capacity_frac,
        "policy": policy,
        "planner_on": planner_on,
        "window_frac": window_frac,
        "epochs": epochs,
    })
    c = min(1.0, max(0.0, capacity_frac))
    if block_frac > 0.0 or span_frac > 0.0:
        hit_model = block_cache_hit_model(
            c, policy, block_frac, span_frac, window_frac
        )
    else:
        hit_model = cache_hit_model(c, policy, window_frac)
    per_epoch = storage_records / epochs
    measured_hit = 1.0 - per_epoch / n_records

    r.add(
        "hit_rate",
        measured_hit,
        hit_model,
        tol_abs=hit_rate_tolerance(policy),
        note=f"cache_hit_model(c={c:g}, {policy})",
    )
    # planner floor: (1 − hit)·n, plus the modeled waste when the
    # planner is off and admission is arrival-ordered (wasted_read_
    # fraction is 0 with the planner on)
    waste = wasted_read_fraction(c, policy, batch_frac, planner_on,
                                 window_frac)
    expected_reads = (1.0 - hit_model + waste) * n_records
    r.add(
        "storage_records_per_epoch",
        per_epoch,
        expected_reads,
        tol_abs=TOLERANCES["storage_reads_frac_of_n"] * n_records,
        note="(1 − hit)·n planner floor" + ("" if planner_on else " + waste"),
    )
    model = _resolve_device(device)
    if model is not None and storage_ios > 0:
        # both sides priced through the same StorageModel: measured ios/
        # bytes vs the floor's counts at the measured coalescing factor
        rec_per_io = storage_records / storage_ios
        exp_ios = expected_reads / max(rec_per_io, 1e-9)
        measured_t = model.t_epoch_read(
            _PlanShim(storage_ios / epochs, storage_bytes / epochs,
                      queue_depth)
        )
        expected_t = model.t_epoch_read(
            _PlanShim(exp_ios, expected_reads * record_bytes, queue_depth)
        )
        r.add(
            "t_epoch_read_s",
            measured_t,
            expected_t,
            tol_rel=TOLERANCES["epoch_read_rel"],
            note=f"{model.name} pricing of measured vs modeled reads",
        )
    return r


def distributed_report(
    *,
    n_records: int,
    hosts: int,
    capacity_frac_global: float,
    policy: str,
    window_frac: float,
    epochs: int,
    remote_hits: float,
    storage_records: float,
    local_hits: float,
) -> DriftReport:
    """Drift report for the multi-host tier: measured local/remote/
    storage record fractions (fleet totals over ``epochs`` steady
    epochs) vs :func:`distributed_hit_model`.

    ``local_hits`` must count consumptions served by the *cross-epoch*
    local tier — for the live cluster that is ``Cluster.aggregate_io()``
    ["local_hits"], which subtracts the source-counted prefetch fills
    (``IOStats.peer_refills`` + ``prefetch_fills``) from the demand-time
    DRAM gathers; ``DistributedCacheSim`` counts the same quantity
    directly."""
    if epochs < 1:
        raise ValueError("need at least one steady epoch of measurements")
    split = distributed_hit_model(capacity_frac_global, hosts, policy,
                                  window_frac)
    total = float(epochs * n_records)
    r = DriftReport(context={
        "layer": "distributed",
        "n_records": n_records,
        "hosts": hosts,
        "capacity_frac_global": capacity_frac_global,
        "policy": policy,
        "epochs": epochs,
    })
    for name, measured in (
        ("local", local_hits / total),
        ("remote", remote_hits / total),
        ("storage", storage_records / total),
    ):
        r.add(
            f"split/{name}",
            measured,
            split[name],
            tol_abs=TOLERANCES["split_abs"],
            note=f"distributed_hit_model(c={capacity_frac_global:g}, "
                 f"H={hosts}, {policy})",
        )
    return r
