"""The program's MoE routing decisions in the check steps, for the forced
reference (``reference/lm.py``'s ``Ref.route``).

The program routes each MoE layer by one top k (``aten.topk``) of its
router's probabilities over the routed experts, taking
``num_experts_per_tok``.  ``Recorder`` is a ``TorchDispatchMode``:
installed around a training step (``wrap``), it keeps the ids of every
such top k, in the order of the calls, and nothing else; no function of
the program is replaced.  A dispatch mode, and not a function mode, since
autograd runs the backward, and with it the checkpoints' recomputation,
under the dispatch modes that were on when it started, and under no
function mode.  A step routes its layers in order in the forward; under
``remat`` "dots" or "full" the backward recomputes each layer's routing
once, last layer first.  ``split`` gives the forward's routes by layer and counts the
recomputed calls that routed otherwise, or that are missing or extra
(``route_recompute_mismatch``: gradients of another function than the
forward's are a fault).

The recorder is installed only around the check steps' calls of
``Trainer.step_fn`` and taken away before the window, which runs the
program as it is.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

TOPK = torch.ops.aten.topk.default


class Recorder(TorchDispatchMode):
    """Routing ids (B, S, k) of every top k of ``k`` over ``experts``
    columns, a list a step."""

    def __init__(self, experts: int, k: int):
        super().__init__()
        self.experts, self.k = experts, k
        self.steps: List[List[torch.Tensor]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is TOPK and self.steps:
            probs, k = args[0], args[1]
            if k == self.k and probs.dim() >= 2 and probs.shape[-1] == self.experts:
                self.steps[-1].append(out[1])
        return out

    def wrap(self, step_fn: Callable) -> Callable:
        """``step_fn`` with this recorder installed for each call, one list
        of calls a step."""
        def recorded(state, batch):
            self.steps.append([])
            with self:
                return step_fn(state, batch)

        return recorded

    def split(self, layers: List[int], recomputed: bool
              ) -> Tuple[List[Dict[int, torch.Tensor]], int]:
        """``(routes, mismatch)``: each step's forward ids by layer (on the
        CPU), for the layers that route (the reference module's
        ``moe_layers``), in order; and the recomputed calls that differ
        from their layer's forward or are missing or extra.  Raises where
        a step's forward routed fewer layers than that: the program no
        longer routes by a top k and the check cannot follow it."""
        routes, mismatch, n = [], 0, len(layers)
        for calls in self.steps:
            if len(calls) < n:
                raise RuntimeError(f"the recorder saw {len(calls)} routing calls in a step of "
                                   f"{n} MoE layers: the program's routing is not a top k")
            fwd, again = calls[:n], calls[n:]
            want = n if recomputed else 0
            mismatch += abs(len(again) - want)
            for j, ids in enumerate(again[:want]):
                mismatch += int(not torch.equal(ids, fwd[n - 1 - j]))
            routes.append({l: ids.cpu() for l, ids in zip(layers, fwd)})
        return routes, mismatch
