"""The train step (with optional microbatching), the port of
``repro.train.steps``.

``make_train_step(cfg, optimizer)`` returns ``train_step(state, batch)``,
which takes the gradient of ``loss_fn`` by autograd and applies AdamW.
The JAX step is jitted with its state donated; this one updates the
state's tensors in place and returns the same state object, with the
metrics as 0-d device tensors (reading them waits for the device).
Gradient compression (``compressor``) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamW
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def _no_compressor(compressor) -> None:
    if compressor is not None:
        raise NotImplementedError("gradient compression is not ported yet")


def init_train_state(cfg: ModelConfig, generator: torch.Generator, optimizer: AdamW,
                     device, compressor=None):
    """Random parameters from ``generator`` (on ``device``), the
    optimizer's state and a step count."""
    _no_compressor(compressor)
    params = M.init_params(cfg, generator, device)
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_train_step(cfg: ModelConfig, optimizer: AdamW, microbatches: int = 1,
                    compressor=None):
    _no_compressor(compressor)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = M.loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(state, batch):
        params = state["params"]
        if microbatches > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"batch of {rows} does not split into {microbatches} microbatches")
            loss, grads = 0.0, None
            for i in range(microbatches):
                mb = {k: v.chunk(microbatches)[i] for k, v in batch.items()}
                mloss, _, mgrads = grad_fn(params, mb)
                loss = loss + mloss
                if grads is None:
                    grads = [g.float() for g in mgrads]
                else:
                    for acc, g in zip(grads, mgrads):
                        acc.add_(g)
            loss = loss / microbatches
            for g in grads:
                g.div_(microbatches)
            metrics = {}
        else:
            loss, metrics, grads = grad_fn(params, batch)
        state["step"].add_(1)
        opt_metrics = optimizer.update(tree_unflatten(params, grads), state["opt"], params)
        return state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
