"""Fault-tolerant training loop wiring model + optimizer + LIRS pipeline
(the port of ``repro.train.loop``).

  * LIRS / BMF / TFIP / CorgiPile batch composition over a real RecordStore
  * background prefetch with Eq. 1 accounting (T_load/T_comp/T_overlap)
  * periodic atomic checkpoints + exact resume (model, optimizer, sampler)
  * simulated preemption (``fail_at_step``)

The step runs on ``device`` (``cuda`` unless the caller asks for the CPU).
Each batch's decoded numpy arrays are copied there synchronously
(``to_device``).  ``_log`` reads every metric with ``float``, which
waits for the device, so the pipeline's ``t_comp`` holds the device's
time of the step (Eq. 1), as in the JAX loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core.pipeline import InputPipeline
from repro_torch.core.shuffler import (
    BMFShuffler,
    CorgiPileShuffler,
    CorgiSquaredShuffler,
    LIRSShuffler,
    TFIPShuffler,
)
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as _trace
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step


class PreemptionError(RuntimeError):
    pass


@dataclasses.dataclass
class TrainLoopConfig:
    epochs: int = 1
    max_steps: int = 0  # 0 = no cap
    ckpt_every: int = 50
    ckpt_dir: str = ""
    fail_at_step: int = -1  # simulate preemption (tests)
    seed: int = 0


def make_shuffler(kind: str, num_items: int, batch_size: int, seed: int = 0, **kw):
    if kind == "lirs":
        return LIRSShuffler(num_items, batch_size, seed=seed, **kw)
    if kind == "lirs_page":
        return LIRSShuffler(num_items, batch_size, seed=seed, page_aware=True, **kw)
    if kind == "bmf":
        nb = max(1, num_items // batch_size)
        return BMFShuffler(num_items, nb, seed=seed)
    if kind == "tfip":
        return TFIPShuffler(num_items, batch_size, kw.pop("queue_size", 16), seed=seed)
    if kind in ("corgipile", "corgi2"):
        cls = CorgiPileShuffler if kind == "corgipile" else CorgiSquaredShuffler
        return cls(
            num_items,
            batch_size,
            kw.pop("block_records", max(1, batch_size // 2)),
            buffer_blocks=kw.pop("buffer_blocks", 2),
            seed=seed,
            **kw,
        )
    raise ValueError(kind)


def to_device(device: torch.device) -> Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]]:
    """The pipeline's ``put_fn``: copies each array of a batch to ``device``."""
    def put(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}

    return put


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        fetch_fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
        shuffler,
        loop_cfg: TrainLoopConfig,
        opt_cfg: AdamWConfig = AdamWConfig(),
        num_producers: int = 1,
        device="cuda",
    ):
        """Parameters are drawn from a ``torch.Generator`` seeded with
        ``loop_cfg.seed`` on ``device``."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.optimizer = AdamW(opt_cfg)
        self.shuffler = shuffler
        self.pipeline = InputPipeline(
            batch_iter_fn=shuffler.epoch_batches,
            fetch_fn=fetch_fn,
            put_fn=to_device(self.device),
            num_producers=num_producers,
        )
        self.step_fn = make_train_step(cfg, self.optimizer)
        gen = torch.Generator(device=self.device).manual_seed(loop_cfg.seed)
        self.state = init_train_state(cfg, gen, self.optimizer, self.device)
        self.global_step = 0
        self.start_epoch = 0
        self.start_step_in_epoch = 0
        # the newest two checkpoints are kept, the JAX loop's default
        self.ckpt = CheckpointManager(loop_cfg.ckpt_dir, keep=2) if loop_cfg.ckpt_dir else None
        self.history: list = []
        self.step_seconds: list = []  # host clock per step, ending in _log's sync

    # ------------------------------------------------------------ resume
    def try_resume(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        self.state, extra, step = self.ckpt.restore(self.state)
        self.global_step = step
        self.start_epoch = extra.get("epoch", 0)
        self.start_step_in_epoch = extra.get("step_in_epoch", 0)
        return True

    # ------------------------------------------------------------- train
    def train(self) -> Dict[str, Any]:
        lc = self.loop_cfg
        step_in_epoch = 0
        try:
            for epoch in range(self.start_epoch, lc.epochs):
                skip = self.start_step_in_epoch if epoch == self.start_epoch else 0
                step_in_epoch = 0
                for batch in self.pipeline.epoch(epoch):
                    if step_in_epoch < skip:  # replaying a resumed epoch
                        step_in_epoch += 1
                        continue
                    if lc.fail_at_step >= 0 and self.global_step == lc.fail_at_step:
                        raise PreemptionError(f"simulated preemption @ {self.global_step}")
                    t0 = time.perf_counter()
                    with _trace.span(
                        "train/step",
                        "train",
                        args={"step": self.global_step, "epoch": epoch}
                        if _trace.enabled()
                        else None,
                    ):
                        self.state, metrics = self.step_fn(self.state, batch)
                    self.global_step += 1
                    step_in_epoch += 1
                    self._log(epoch, metrics)
                    self.step_seconds.append(time.perf_counter() - t0)
                    if self.ckpt and self.global_step % lc.ckpt_every == 0:
                        self._save(epoch, step_in_epoch)
                    if lc.max_steps and self.global_step >= lc.max_steps:
                        return self.summary()
                if self.ckpt:
                    self._save(epoch + 1, 0)
        except (KeyboardInterrupt, PreemptionError):
            # preemption path: persist everything needed for exact resume
            if self.ckpt:
                self._save(epoch, step_in_epoch)
            raise
        return self.summary()

    def _save(self, epoch: int, step_in_epoch: int = 0):
        self.ckpt.save(
            self.global_step,
            self.state,
            extra={"epoch": epoch, "step_in_epoch": step_in_epoch},
        )

    def _log(self, epoch: int, metrics: Dict):
        self.history.append({
            "step": self.global_step,
            "epoch": epoch,
            **{k: float(v) for k, v in metrics.items()},
        })

    def summary(self) -> Dict[str, Any]:
        s = self.pipeline.stats
        return {
            "steps": self.global_step,
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "t_load": s.t_load,
            "t_comp": s.t_comp,
            "t_overlap": s.t_overlap,
            "t_unhidden_load": s.t_wait,
            "effective_time": s.effective_epoch_time(),
        }
