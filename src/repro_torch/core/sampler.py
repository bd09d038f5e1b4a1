"""Deterministic sharded sampler for multi-host data parallelism.

Every host evaluates the same keyed permutation π_epoch; host ``h`` of
``H`` owns a contiguous slot range inside each global step.  The full
pipeline state is (seed, epoch, step) — three ints — which makes
checkpoint/restart exact, elastic re-sharding a pure remap, and straggler
mitigation a metadata operation (slot stealing).  This is the LIRS scaling
thesis (DESIGN.md §3): the *shuffle* is communication-free; only the reads
are local.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.assignment import FeistelAssignment, TableAssignment


@dataclasses.dataclass
class SamplerState:
    seed: int
    epoch: int
    step: int

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "SamplerState":
        return SamplerState(**d)


class ShardedSampler:
    def __init__(
        self,
        num_items: int,
        global_batch: int,
        num_hosts: int,
        host_id: int,
        seed: int = 0,
        assignment: str = "feistel",
        drop_last: bool = True,
    ):
        assert 0 <= host_id < num_hosts
        # uneven splits are allowed: ownership is a bounds array, so an
        # elastic fleet of any size can adopt the stream (DESIGN.md §3)
        self.num_items = num_items
        self.global_batch = global_batch
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.local_batch = global_batch // num_hosts
        cls = FeistelAssignment if assignment == "feistel" else TableAssignment
        self.assignment = cls(num_items, seed)
        self.seed = seed
        self.state = SamplerState(seed=seed, epoch=0, step=0)
        self.steps_per_epoch = num_items // global_batch if drop_last else -(
            -num_items // global_batch
        )
        # slot ownership inside a step: host h owns [bounds[h], bounds[h+1])
        self._bounds = self._even_bounds(num_hosts, global_batch)

    @staticmethod
    def _even_bounds(num_hosts: int, global_batch: int) -> np.ndarray:
        return np.linspace(0, global_batch, num_hosts + 1).astype(np.int64)

    # ----------------------------------------------------------- batches
    def _slots(self, step: int, host_id: Optional[int] = None) -> np.ndarray:
        h = self.host_id if host_id is None else host_id
        lo, hi = self._bounds[h], self._bounds[h + 1]
        base = step * self.global_batch
        return np.arange(base + lo, base + hi, dtype=np.int64)

    def next_batch(self) -> np.ndarray:
        """Local indices for this host at the current (epoch, step)."""
        idx = self.assignment.index_at(self.state.epoch, self._slots(self.state.step))
        self._advance()
        return idx

    def global_batch_indices(self, epoch: int, step: int) -> np.ndarray:
        base = step * self.global_batch
        slots = np.arange(base, base + self.global_batch, dtype=np.int64)
        return self.assignment.index_at(epoch, slots)

    def _advance(self):
        self.state.step += 1
        if self.state.step >= self.steps_per_epoch:
            self.state.step = 0
            self.state.epoch += 1

    # ---------------------------------------------------- fault tolerance
    def checkpoint(self) -> Dict:
        return {
            "sampler": self.state.to_dict(),
            "num_hosts": self.num_hosts,
            "bounds": self._bounds.tolist(),
        }

    def restore(self, ckpt: Dict):
        self.state = SamplerState.from_dict(ckpt["sampler"])
        if ckpt.get("bounds") and len(ckpt["bounds"]) == self.num_hosts + 1:
            self._bounds = np.asarray(ckpt["bounds"], dtype=np.int64)

    # ------------------------------------------------------------ elastic
    def reshard(self, new_num_hosts: int, new_host_id: int) -> "ShardedSampler":
        """Continue the exact same global sample stream on a different host
        count — zero data movement (metadata-only)."""
        s = ShardedSampler(
            self.num_items,
            self.global_batch,
            new_num_hosts,
            new_host_id,
            seed=self.seed,
            assignment=self.assignment.kind,
        )
        s.state = SamplerState(self.seed, self.state.epoch, self.state.step)
        return s

    # --------------------------------------------------------- stragglers
    def steal_slots(self, slow_host: int, fast_host: int, count: int):
        """Move ``count`` slots of each step from a slow host to a fast one.
        Only the bounds array changes — no data moves (adjacent hosts)."""
        if abs(slow_host - fast_host) != 1:
            raise ValueError("slot stealing operates on adjacent hosts")
        b = self._bounds.copy()
        if fast_host < slow_host:  # fast host extends right
            b[slow_host] += count
        else:  # fast host extends left
            b[fast_host] -= count
        if np.any(np.diff(b) < 0):
            raise ValueError("steal would make a shard negative")
        self._bounds = b

    def shard_sizes(self) -> List[int]:
        return np.diff(self._bounds).astype(int).tolist()
