"""``remat="dots"`` keeps no bf16 weight cast for the backward.

JAX's ``checkpoint_dots`` saves the products' outputs and recomputes
everything else, the f32 -> bf16 weight casts included.  The port's
``"dots"`` runs each pattern period and the logits' product under
``layers.common.recast_weights``: a tensor autograd saves that lies in a
cast's storage is kept as its f32 weight, and the backward casts it
again.  On the smoke configs of every
ported block kind in bf16 compute (``attn``, ``local_attn``, ``rglru``,
``moe`` with both dispatches, ``mlstm`` and ``slstm``), these tests hold
a weak reference to the storage of every weight cast and record what the
hooks keep:
  * after the forward under ``"dots"``, before the backward, every cast's
    storage is freed: nothing (a saved tensor, a view of one, the
    hooks' registry) keeps it; the same forward without remat keeps
    some (the detector works);
  * the loss and every gradient equal ``"full"``'s bit for bit
    (``torch.equal``): a recast has the same bits as the cast.
"""
import dataclasses

import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.configs import get_config
from repro_torch.layers import attention, common, mlp, moe, rglru, xlstm
from repro_torch.models import model as tm
from repro_torch.utils.tree import tree_leaves, tree_unflatten

CASES = [("recurrentgemma-2b", None), ("granite-3-8b", None),
         ("qwen2-moe-a2.7b", "dense"), ("qwen2-moe-a2.7b", "ragged"), ("xlstm-1.3b", None)]


def _cfg(arch, impl):
    cfg = get_config(arch, smoke=True)
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
    if impl is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl=impl))
    return cfg


def _batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=g, dtype=torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class _Recorder:
    """A weak reference to the storage of every weight cast of a forward,
    and every object that autograd keeps for the backward while a
    ``recast_weights`` scope or ``observe()`` is active."""

    def __init__(self, monkeypatch):
        self.casts, self.kept = [], []
        real_cast, real_hooks = common.cast, torch.autograd.graph.saved_tensors_hooks

        def recording_cast(w, dtype):
            c = real_cast(w, dtype)
            if c is not w:
                assert c.dtype == torch.bfloat16
                self.casts.append(StorageWeakRef(c.untyped_storage()))
            return c

        recorder = self

        class RecordingHooks(real_hooks):
            def __init__(self, pack, unpack):
                def recording_pack(t):
                    out = pack(t)
                    recorder.kept.append(out)
                    return out

                super().__init__(recording_pack, unpack)

        for mod in (attention, mlp, rglru, moe, xlstm, tm):
            monkeypatch.setattr(mod, "cast", recording_cast)
        monkeypatch.setattr(torch.autograd.graph, "saved_tensors_hooks", RecordingHooks)
        self.hooks = RecordingHooks

    def observe(self):
        return self.hooks(lambda t: t, lambda t: t)

    def live_casts(self):
        return sum(not ref.expired() for ref in self.casts)


def _forward(cfg, params, batch):
    leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
    loss, met = tm.loss_fn(cfg, tree_unflatten(params, leaves), batch)
    return loss, met["aux"], leaves


def _loss_and_grads(cfg, params, batch):
    loss, aux, leaves = _forward(cfg, params, batch)
    return loss, aux, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch,impl", CASES)
def test_dots_keeps_no_weight_cast(monkeypatch, arch, impl):
    cfg = _cfg(arch, impl)
    params = tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = _batch(cfg, 4)

    rec = _Recorder(monkeypatch)
    with rec.observe():  # no remat: the products keep their weight casts
        loss = _forward(cfg.replace(remat="none"), params, batch)
    assert rec.casts and rec.live_casts() > 0
    del loss

    rec = _Recorder(monkeypatch)
    loss, aux, leaves = _forward(cfg.replace(remat="dots"), params, batch)
    recast = [t for t in rec.kept if isinstance(t, tuple)]
    periods = sum(r for _, r in cfg.stages)
    assert len(rec.casts) >= periods and len(recast) >= periods
    assert rec.live_casts() == 0
    grads = torch.autograd.grad(loss, leaves)

    monkeypatch.undo()
    want = _loss_and_grads(cfg.replace(remat="full"), params, batch)
    assert torch.equal(loss, want[0]) and torch.equal(aux, want[1])
    assert all(torch.equal(a, b) for a, b in zip(grads, want[2]))


def test_cast_is_a_plain_cast_outside_recast_weights():
    w = torch.randn(4, 6)
    assert common.cast(w, torch.float32) is w
    assert torch.equal(common.cast(w, torch.bfloat16), w.to(torch.bfloat16))
    with common.recast_weights():
        c = common.cast(w, torch.bfloat16)
    assert torch.equal(c, w.to(torch.bfloat16))
