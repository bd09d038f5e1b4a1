"""Device meshes, and the CPU process mesh.

The device meshes are the port of ``repro.launch.mesh``'s XLA meshes:
``torch.distributed`` ``DeviceMesh`` objects whose dims carry the JAX
axis names, so the spec rules (:mod:`repro_torch.sharding.specs`) name
them alike.

- ``make_production_mesh``: single pod 16×16 = 256 ranks, dims
  ``("data", "model")``; multi-pod 2×16×16 = 512 ranks, ``("pod",
  "data", "model")``, the pod dim pure data parallelism.  It runs over
  PyTorch's fake backend (``FakeStore``, 512 ranks, this process rank 0),
  the counterpart of JAX's 512 forced host devices; the single-pod mesh
  takes the first 256 ranks.  The fake backend's collectives return no
  real data: the mesh is for meta tensors and counting only (the dry
  run, :mod:`repro_torch.launch.dryrun`).
- ``make_host_mesh``: a small mesh over the default process group (tests
  and the card).

Functions, not module constants: importing this module touches no
process group.

The CPU process mesh is the multi-*host* substrate of the distributed
clairvoyant I/O tier (:mod:`repro_torch.prefetch.distributed`).  Each OS
process is one "host" running its own record store, cache and peer
server, talking TCP to the others (:mod:`repro_torch.prefetch.transport`).
No device, no shared memory: what a real multi-node launch of the data
plane looks like, minus the cluster scheduler.
"""
from __future__ import annotations

import math
import multiprocessing
import queue as _queue
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

PRODUCTION_RANKS = 512  # the fake group's world: the multi-pod mesh's ranks


def _fake_group() -> None:
    """This process as rank 0 of the fake PRODUCTION_RANKS-rank group,
    unless that group is up already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != PRODUCTION_RANKS:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up; the "
                               f"production meshes need the fake group of {PRODUCTION_RANKS}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=PRODUCTION_RANKS)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` mesh, over the fake 512-rank
    group (started here if none is up).  Its device type is the CPU's,
    and the tensors laid out on it live on the meta device."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _fake_group()
    need = math.prod(shape)
    return DeviceMesh("cpu", torch.arange(need).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A ``(data, model)`` mesh over the default process group, its ranks
    in order.  With no group up and ``data·model == 1``, this starts a
    one-rank group: ``nccl`` for ``device="cuda"``, ``gloo`` for
    ``device="cpu"``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    need = data * model
    if not dist.is_initialized():
        if need != 1:
            raise RuntimeError(f"a ({data}, {model}) mesh needs a process group of {need} ranks")
        port = _free_port()
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    if dist.get_world_size() < need:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {need} ranks, "
                           f"the group has {dist.get_world_size()}")
    return DeviceMesh(device, torch.arange(need).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_axes(mesh) -> tuple:
    """The mesh's data-parallel dims: ``pod`` and ``data``, in order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


# --------------------------------------------------------------------------
# The CPU process mesh.
# --------------------------------------------------------------------------

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
