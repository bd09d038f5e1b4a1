"""The step functions, the port of ``repro.train.steps``: train (with
optional microbatching), prefill and decode.

``make_train_step(cfg, optimizer)`` returns ``train_step(state, batch)``,
which takes the gradient of ``loss_fn`` by autograd and applies AdamW.
The JAX step is jitted with its state donated; this one updates the
state's tensors in place and returns the same state object, with the
metrics as 0-d device tensors (reading them waits for the device).  A
batch is ``tokens``, ``labels`` and the extras the config reads
(``encoder_frames``, ``positions``, ``positions_3d``); microbatching
splits every entry by rows.  With a ``compressor``
(:class:`~repro_torch.train.compression.EFCompressor`) the state carries
``ef_residual`` and the gradients are compressed, then decompressed,
before AdamW, one leaf at a time.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.compression import EFCompressor
from repro_torch.train.optimizer import AdamW
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def init_train_state(cfg: ModelConfig, generator: torch.Generator, optimizer: AdamW,
                     device, compressor: Optional[EFCompressor] = None):
    """Random parameters from ``generator`` (on ``device``), the
    optimizer's state, a step count and, with a ``compressor``, its f32
    error-feedback residual."""
    params = M.init_params(cfg, generator, device)
    state = {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if compressor is not None:
        state["ef_residual"] = compressor.init(params)
    return state


def make_train_step(cfg: ModelConfig, optimizer: AdamW, microbatches: int = 1,
                    compressor: Optional[EFCompressor] = None):
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
        if compressor is not None:
            # error-feedback compression: what would cross the wire
            # is the codes.  Leaf by leaf, so the transients stay one
            # leaf's size; the residual is updated in place
            for i, r in enumerate(tree_leaves(state["ef_residual"])):
                compressed, (new_r,) = compressor.compress([grads[i]], [r])
                r.copy_(new_r)
                (grads[i],) = compressor.decompress(compressed)
        opt_metrics = optimizer.update(tree_unflatten(params, grads), state["opt"], params)
        return state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, tokens, extras=None) -> (cache, logits)``:
    ``M.prefill``."""
    def prefill_step(params, tokens, extras=None):
        return M.prefill(cfg, params, tokens, extras)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, cache, tokens, extras=None) -> (cache,
    logits)``: ``M.decode_step``, which updates the cache's leaves in
    place."""
    def decode_step(params, cache, tokens, extras=None):
        return M.decode_step(cfg, params, cache, tokens, extras)

    return decode_step
