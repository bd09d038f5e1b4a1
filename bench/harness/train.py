"""The ``train`` generator: LM training fed by the LIRS read path.

Set-up writes the mix's corpus from the seed into a record file under
``TMPDIR`` (``RecordWriter``), opens it (``RecordStore``), builds one
``Trainer`` over a ``LIRSShuffler`` whose batches are read with
``read_batch_into`` and decoded with ``decode_token_batch`` in the
pipeline's producer thread, draws the weights into the trainer's
parameters, and runs the first ``check_steps`` steps through
``Trainer.train`` (one, then the rest), reading the program's side of the
check from them; for a MoE configuration with ``routes.Recorder`` around
each of those steps, which keeps the program's routing decisions.  The
window is the same trainer's ``train`` on from there, with the recorder
taken away and ``max_steps`` set from set-up's step time so that it lasts
about ``--seconds``; tokens a second are all its tokens over all its time.

After the window the program is freed, and the configuration's reference
follows the first steps on the same corpus rows and weights, made again
from the seed, routing each MoE layer as the program did.  The epoch's
record ids and every batch the window fed are checked against the corpus.
"""
from __future__ import annotations

import gc
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness import common, flops, profile, routes, spec, weights

GIB = 2 ** 30


def corpus(seed: int, records: int, width: int, vocab: int) -> np.ndarray:
    """The mix's token rows: ``records`` × ``width`` int32 ids, uniform over
    the vocabulary, from the seed."""
    rng = np.random.default_rng([int(seed), 0xC0])
    return rng.integers(0, vocab, size=(records, width), dtype=np.int32)


class Feed:
    """The trainer's fetch and put: the port's batch read and decode and
    its copy to the card, with each batch's record ids and device tensors
    kept for the check.  ``skip`` batches at the start of a ``train`` call
    are the ones it replays past, as a resumed epoch does."""

    def __init__(self, store, seq: int, device, workers: int):
        from repro_torch.data.synthetic import decode_token_batch
        from repro_torch.train.loop import to_device

        self.store, self.seq, self.workers = store, seq, workers
        self.decode = decode_token_batch
        self.to_device = to_device(device)
        self.fed: List[Dict] = []
        self.skip = 0
        self.traced = None

    def fetch(self, idx):
        batch = self.decode(self.store.read_batch_into(idx, workers=self.workers), self.seq)
        batch["ids"] = np.asarray(idx)
        return batch

    def put(self, raw):
        if self.traced is not None and self.traced.due():
            self.traced.pause()
        out = self.to_device({"tokens": raw["tokens"], "labels": raw["labels"]})
        if self.skip:
            self.skip -= 1
        else:
            self.fed.append({"ids": raw["ids"], **out})
        return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device) -> Dict:
    from repro_torch.core.shuffler import LIRSShuffler
    from repro_torch.models.model import AUX_LOSS_WEIGHT
    from repro_torch.storage.record_store import RecordStore, RecordWriter
    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.train.optimizer import AdamWConfig

    t_setup = time.perf_counter()
    phases = common.Phases()
    mix, conf, ref = cell.mix, cell.config, cell.reference
    cfg = spec.port_config(conf, remat=mix["remat"], ref=ref)
    aux_weight = conf.get("router_aux_loss_coef", 0.0)
    if cfg.moe is not None and aux_weight != AUX_LOSS_WEIGHT:
        raise ValueError(f"the port's aux loss weight {AUX_LOSS_WEIGHT} is not the file's {aux_weight}")
    n, seq, bsz, k = mix["records"], mix["seq_len"], mix["batch"], mix["check_steps"]
    opt = mix["optimizer"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tmp = tempfile.mkdtemp(prefix="bench_corpus_")
    store = None
    try:
        rows = corpus(seed, n, seq + 1, conf["vocab_size"])
        path = os.path.join(tmp, "corpus.rrec")
        with RecordWriter(path, record_size=rows.shape[1] * 4) as w:
            for r in rows:
                w.append(r.tobytes())
        del rows
        phases.mark("corpus")
        store = RecordStore(path)
        feed = Feed(store, seq, device, mix["io_workers"])
        shuffler = LIRSShuffler(n, bsz, seed=seed)
        loop = TrainLoopConfig(epochs=1, max_steps=1, seed=seed)
        trainer = Trainer(cfg, feed.fetch, shuffler, loop, opt_cfg=AdamWConfig(**opt),
                          put_fn=feed.put, num_producers=mix["producers"], device=device)
        phases.mark("trainer")
        weights.fill_port(ref, conf, seed, trainer.state["params"])
        phases.mark("weights")
        step_fn, recorder = trainer.step_fn, None
        if cfg.moe is not None:
            recorder = routes.Recorder(flops.experts(conf)[1], cfg.moe.experts_per_token)
            trainer.step_fn = recorder.wrap(step_fn)
        trainer.train()  # step 1: the first gradient, as AdamW's first moment holds it
        phases.mark("step1")
        first = {name: float(mu.norm()) / (1.0 - opt["b1"])
                 for name, mu in weights.by_name(ref, conf, trainer.state["opt"]["mu"]).items()}
        loop.max_steps, trainer.start_step_in_epoch, feed.skip = k, 1, 1
        trainer.train()
        trainer.step_fn = step_fn
        phases.mark("steps")
        change = {name: float((p - weights.make_one(ref, conf, seed, name, device)).norm())
                  for name, p in weights.by_name(ref, conf, trainer.state["params"]).items()}
        program = {"losses": [h["loss"] for h in trainer.history[:k]],
                   "grad_norms": first, "change_norms": change}
        if recorder is not None:
            program["routes"], program["route_recompute_mismatch"] = recorder.split(
                ref.moe_layers(conf), cfg.remat in ("dots", "full"))
            recorder.steps.clear()
        step_s = statistics.median(trainer.step_seconds[1:k])
        steps = max(1, round(seconds / step_s))
        checked = list(feed.fed)
        phases.mark("readings")
        setup_s = time.perf_counter() - t_setup

        loop.max_steps, trainer.start_step_in_epoch, feed.skip = k + steps, k, k
        stats = trainer.pipeline.stats
        wait0, load0 = stats.t_wait, stats.t_load
        with profile.Traced(trace, mix["trace_seconds"]) as traced:
            feed.traced = traced
            t0 = time.perf_counter()
            trainer.train()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
            traced.pause()
        feed.traced = None
        done = trainer.global_step - k
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        run_info = {
            "kind": "train", "config": conf, "mix": mix, "steps": done, "window_s": window_s,
            "tokens": done * bsz * seq, "t_wait_s": stats.t_wait - wait0,
            "t_load_s": stats.t_load - load0,
            "trace": traced.events() if trace else None,
        }
        fed = feed.fed[len(checked):]
        perm = np.concatenate(list(shuffler.epoch_batches(0)))
        del trainer, feed, traced
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        if store is not None:
            store.close()
        shutil.rmtree(tmp, ignore_errors=True)

    checks = _check(cell, seed, device, program, checked, fed, perm)
    tokens_per_s = run_info["tokens"] / window_s
    return {
        "setup_s": setup_s, "attempted": steps, "failed": steps - done,
        "end_to_end": {"train_tokens_per_s": tokens_per_s, "peak_mem_gib": peak / GIB},
        "memory_peak_bytes": peak, "run": run_info, "checks": checks,
        "setup_phases": phases.seconds, "check_ids": [b["ids"] for b in checked], "program": program,
    }


def batch_checks(mix, conf, seed, fed, perm) -> Dict[str, float]:
    """Record ids repeated in the epoch (or missing from its permutation),
    and batches whose tokens or labels are not the corpus rows at their
    ids, against the corpus made again from the seed."""
    n, seq = mix["records"], mix["seq_len"]
    rows = corpus(seed, n, seq + 1, conf["vocab_size"])
    ids = np.concatenate([b["ids"] for b in fed])
    repeats = (len(ids) - len(np.unique(ids))) + (n - len(np.unique(perm))) + int(len(perm) != n)
    wrong = 0
    for b in fed:
        want = torch.from_numpy(rows[b["ids"]])
        got_t, got_l = b["tokens"].cpu(), b["labels"].cpu()
        wrong += int(not (torch.equal(got_t, want[:, :-1]) and torch.equal(got_l, want[:, 1:])))
    return {"batches_unlike_corpus": float(wrong), "epoch_id_repeats": float(repeats)}


def reference_readings(cell, seed: int, device, ids: List[np.ndarray], precision: str = "f32",
                       loss_tokens: float = 1.0, routes=None) -> Dict:
    """The reference's losses, first gradients' and changes' norms over the
    corpus rows ``ids`` (one array a step), in ``precision``; a MoE
    configuration routes by ``routes`` (ids by layer, a step:
    the program's, or another side's) where they are given, and returns
    its own where not (``train_readings``).  ``loss_tokens`` < 1 plants a
    fault: the loss over that leading share of each sequence's tokens
    only."""
    mix, conf, ref = cell.mix, cell.config, cell.reference
    rows = corpus(seed, mix["records"], mix["seq_len"] + 1, conf["vocab_size"])
    cut = max(1, int(round(mix["seq_len"] * loss_tokens)))
    batches = [{"tokens": torch.from_numpy(rows[i][:, :-1]).to(device),
                "labels": torch.from_numpy(rows[i][:, 1:][:, :cut]).to(device)} for i in ids]
    del rows
    ref.full_f32()
    W = weights.make(ref, conf, seed, device)
    out = ref.train_readings(ref.Ref(conf, precision), W, batches, mix["optimizer"],
                             conf.get("router_aux_loss_coef", 0.0),
                             lambda name: weights.make_one(ref, conf, seed, name, device),
                             steps=len(ids), routes=routes)
    del W
    return out


def side_readings(cell, seed: int, device, ids: List[np.ndarray], **side) -> Tuple[Dict, Dict]:
    """The readings of another side than the program (the float8 control,
    ``precision="fp8"``, or a planted fault), and those of the float32
    reference it is held against, as the program is held: routed by the
    side's own routes, where the model routes."""
    other = reference_readings(cell, seed, device, ids, **side)
    return other, reference_readings(cell, seed, device, ids, routes=other.get("routes"))


def side_gaps(cell, seed: int, device, ids: List[np.ndarray], **side) -> Dict[str, float]:
    """``gaps`` of another side than the program (``side_readings``)."""
    return gaps(*side_readings(cell, seed, device, ids, **side))


def leaf_gaps(program: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Every step's and every leaf's gap behind ``gaps``, for a look at
    which one reads the most."""
    gmed = statistics.median(ref["grad_norms"].values())
    cmed = statistics.median(ref["change_norms"].values())
    return {
        "loss": {str(i): abs(p - q) / abs(q)
                 for i, (p, q) in enumerate(zip(program["losses"], ref["losses"]))},
        "grad": {k: abs(program["grad_norms"][k] - v) / max(v, gmed)
                 for k, v in ref["grad_norms"].items()},
        "change": {k: abs(program["change_norms"][k] - v) / max(v, cmed)
                   for k, v in ref["change_norms"].items()},
    }


def gaps(program: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: the largest relative gap of a step's loss; of
    a leaf's first-gradient norm and of its change's norm (worst leaf,
    ``common.worst_leaf_gap``), the change over the leaves whose reference
    gradient is at least a thousandth of the median leaf's.  A reference
    routed by the program's routes adds ``route_gap``: the share of those
    (token, choice) pairs that it ranks outside its own top k by more than
    its near-tie margin."""
    med = statistics.median(ref["grad_norms"].values())
    moved = [k for k, g in ref["grad_norms"].items() if g >= 1e-3 * med]
    out = {
        "loss_gap": max(abs(p - q) / abs(q) for p, q in zip(program["losses"], ref["losses"])),
        "grad_gap": common.worst_leaf_gap(program["grad_norms"], ref["grad_norms"]),
        "update_gap": common.worst_leaf_gap(program["change_norms"], ref["change_norms"], moved),
    }
    if "route_pairs" in ref:
        out["route_gap"] = ref["route_outside"] / ref["route_pairs"]
    return out


def _check(cell, seed, device, program, checked, fed, perm) -> List[Dict]:
    """The reference follows the first steps; the ids and batches are
    compared with the corpus made again from the seed."""
    counts = batch_checks(cell.mix, cell.config, seed, checked + fed, perm)
    if "route_recompute_mismatch" in program:
        counts["route_recompute_mismatch"] = float(program["route_recompute_mismatch"])
    ref = reference_readings(cell, seed, device, [b["ids"] for b in checked],
                             routes=program.get("routes"))
    found = gaps(program, ref)
    return ([common.check(k, v, cell.limits[k]) for k, v in found.items()]
            + [common.check(k, v, 0.0) for k, v in counts.items()])
