"""The CPU process mesh: the multi-*host* substrate of the distributed
clairvoyant I/O tier (:mod:`repro_torch.prefetch.distributed`).

Each OS process is one "host" running its own record store, cache and
peer server, talking TCP to the others
(:mod:`repro_torch.prefetch.transport`).  No device, no shared memory:
what a real multi-node launch of the data plane looks like, minus the
cluster scheduler.  This is the port of the process-mesh half of
``repro.launch.mesh``; its device meshes (XLA's ``("data", "model")``
meshes) have no counterpart here yet.
"""
from __future__ import annotations

import multiprocessing
import queue as _queue
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

_MESH_FAILED = "__cpu_mesh_round_failed__"


@dataclass(frozen=True)
class HostSpec:
    """One process's identity in a CPU process mesh, plus its rendezvous
    handles.  ``all_gather`` is the only collective the data plane needs:
    each host contributes one picklable value (its peer-server address,
    a result dict, …) and every host receives the full ``{host_id:
    value}`` map — served by the parent process, not a network service."""

    host_id: int
    num_hosts: int
    _up: object = None
    _down: object = None
    timeout_s: float = 60.0

    def all_gather(self, value) -> Dict[int, object]:
        self._up.put((self.host_id, value))
        out = self._down.get(timeout=self.timeout_s)
        if out == _MESH_FAILED:
            raise RuntimeError(
                f"host {self.host_id}: a peer died mid-rendezvous"
            )
        return out


def _cpu_mesh_entry(target, host_id, num_hosts, up, down, timeout_s, args):
    spec = HostSpec(host_id, num_hosts, up, down, timeout_s)
    target(spec, *args)


def run_cpu_process_mesh(
    target: Callable,
    num_hosts: int,
    args: Sequence = (),
    mp_context: str = "fork",
    round_timeout_s: float = 60.0,
    join_timeout_s: Optional[float] = 300.0,
):
    """Run ``target(spec, *args)`` in ``num_hosts`` processes.

    The parent serves ``all_gather`` rounds: it collects one value per
    host, then broadcasts the full map back — any number of rounds, in
    lockstep.  If a host dies mid-round the survivors' pending gather is
    failed (broadcast of a poison value) instead of deadlocking, and the
    non-zero exit is raised here.  ``fork`` start method by default so
    ``target`` may be any callable (tests define them inline); use
    ``spawn`` for module-level targets that must not inherit parent
    state.  Returns the per-host exit codes (all zero on success).
    """
    if num_hosts < 1:
        raise ValueError("num_hosts must be >= 1")
    mpc = multiprocessing.get_context(mp_context)
    up = mpc.Queue()
    downs = [mpc.Queue() for _ in range(num_hosts)]
    procs = []
    for h in range(num_hosts):
        p = mpc.Process(
            target=_cpu_mesh_entry,
            args=(target, h, num_hosts, up, downs[h], round_timeout_s, args),
            daemon=True,
        )
        p.start()
        procs.append(p)
    pending: Dict[int, object] = {}
    failed = False
    while any(p.is_alive() for p in procs):
        try:
            h, val = up.get(timeout=0.1)
        except _queue.Empty:
            if pending and any(
                (not p.is_alive()) and p.exitcode not in (0, None)
                for p in procs
            ):
                # a peer died while others wait on this round: release
                # the survivors with a poison broadcast, let them raise
                for d in downs:
                    d.put(_MESH_FAILED)
                pending = {}
                failed = True
            continue
        pending[h] = val
        if len(pending) == num_hosts:
            snapshot = dict(pending)
            for d in downs:
                d.put(snapshot)
            pending = {}
    for p in procs:
        p.join(timeout=join_timeout_s)
    codes = [p.exitcode for p in procs]
    if failed or any(c != 0 for c in codes):
        raise RuntimeError(f"cpu process mesh failed, exit codes {codes}")
    return codes
