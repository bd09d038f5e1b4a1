"""Paper Table 6 + Table 7 + Fig 12: DNN convergence/accuracy, TFIP vs
LIRS; and Fig 3: test accuracy against the TFIP queue size.

The port of ``benchmarks/dnn_convergence.py`` (``_run``, ``compute``) and
``benchmarks/queue_size.py``.  The dataset is stored CLASS-SORTED
(ImageNet-style layout): a bounded shuffle queue (TFIP) then yields
class-skewed batches, while LIRS mixes globally every epoch.  Three
"model sizes" stand in for AlexNet/OverFeat/VGG16.  Methodology follows
§5.3.1: train TFIP to its minimum validation loss, then count the epochs
LIRS needs to reach it; report final test accuracy for both.

The training set lives on the device (``data.device_table.DeviceTable``)
and each batch is gathered there by the LIRS kernels, where the JAX runs
index ``xs[idx]`` on the host.  The shufflers run over ``len(xs)``
records (``n // classes`` per class), which equals ``n`` at the JAX
benchmark's sizes.  Results are computed afresh (the JAX benchmark's
JSON cache is not ported).

    python -m repro_torch.dnn.convergence --device cpu --n 1200 --epochs 2
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.shuffler import LIRSShuffler, TFIPShuffler
from repro_torch.data.device_table import GATHERS, DeviceTable
from repro_torch.dnn.mlp import MLPClassifier, make_clustered_data

N, DIM, CLASSES = 12000, 32, 20
BATCH = 100
E_MAX = 10
QUEUE = 600  # TFIP default window (paper used 10000 of 1.28M ~ 0.8%; 600/12000 = 5%)
MODELS = {
    "alexnet-like": (64,),
    "overfeat-like": (128, 64),
    "vgg-like": (256, 128, 64),
}
SEEDS = (0, 1, 2)
# queue_size.py's sweep
SWEEP_EPOCHS = 5
QUEUES = (1, 100, 600, 3000)

# init(dims, seed) -> a list of {"w", "b"} layers: the initial weights
Init = Callable[[tuple, int], list]


@dataclass
class Run:
    """One training run: the model, the running minimum of the per-epoch
    validation loss (what ``_run`` returns), the raw per-epoch validation
    losses, each epoch's per-step training losses, the initial weights
    (for a replay), the rows gathered and the wall seconds of the epochs
    (every step ends in a device sync: ``train_batch`` returns a float)."""
    model: MLPClassifier
    val_traj: np.ndarray
    val_loss: List[float]
    losses: List[List[float]]
    init: list
    rows: int
    seconds: float


def train(table: DeviceTable, hidden, shuffler, epochs: int, seed: int, val=None,
          init: Optional[Init] = None) -> Run:
    """``_run``: train a fresh model on ``shuffler``'s batches, gathered
    from ``table``; after each epoch, the loss on ``val = (x, y)``."""
    dims = (table.x.shape[1], *hidden, CLASSES)
    model = MLPClassifier(dims[0], CLASSES, hidden=hidden, seed=seed, device=table.device,
                          params=None if init is None else init(dims, seed))
    start = [{k: v.detach().clone() for k, v in layer.items()} for layer in model.params]
    rows0, t0 = table.rows, time.perf_counter()
    losses, val_loss = [], []
    for e in range(epochs):
        losses.append([model.train_batch(*table.batch(idx)) for idx in shuffler.epoch_batches(e)])
        if val is not None:
            val_loss.append(model.loss(*val))
    traj = np.minimum.accumulate(val_loss) if val_loss else np.zeros(0)
    return Run(model, traj, val_loss, losses, start, table.rows - rows0,
               time.perf_counter() - t0)


def _on(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def compute(n: int = N, queue: int = QUEUE, epochs: int = E_MAX, models=None,
            seeds=SEEDS, gather: str = "block", device="cuda", init: Optional[Init] = None,
            runs: Optional[list] = None) -> dict:
    """``dnn_convergence.compute`` with its result keys.  ``runs``, if a
    list, receives ``(model name, seed, "tfip" | "lirs", Run)`` for each
    run."""
    models = MODELS if models is None else models
    xs, ys, centers = make_clustered_data(n, DIM, CLASSES, seed=42, class_sorted=True, spread=1.0)
    xval, yval, _ = make_clustered_data(2000, DIM, CLASSES, seed=7, class_sorted=False,
                                        centers=centers)
    xte, yte, _ = make_clustered_data(4000, DIM, CLASSES, seed=99, class_sorted=False,
                                      centers=centers)
    table = DeviceTable(xs, ys, device, gather)
    val = _on(table.device, xval, yval)
    test = _on(table.device, xte, yte)
    ntr = len(table)
    out = {}
    for name, hidden in models.items():
        eps_l, acc_t, acc_l = [], [], []
        trajs = None
        for seed in seeds:
            tfip = TFIPShuffler(ntr, BATCH, queue_size=queue, seed=seed)
            r_t = train(table, hidden, tfip, epochs, seed, val, init)
            lirs = LIRSShuffler(ntr, BATCH, seed=seed)
            r_l = train(table, hidden, lirs, epochs, seed, val, init)
            if runs is not None:
                runs += [(name, seed, "tfip", r_t), (name, seed, "lirs", r_l)]
            target = r_t.val_traj[-1]  # TFIP's min validation loss
            el = next((i + 1 for i, v in enumerate(r_l.val_traj) if v <= target), epochs + 1)
            eps_l.append(el)
            acc_t.append(r_t.model.accuracy(*test))
            acc_l.append(r_l.model.accuracy(*test))
            if trajs is None:
                trajs = (r_t.val_traj.tolist(), r_l.val_traj.tolist())
        out[name] = {
            "epochs_tfip": epochs,
            "epochs_lirs_mean": float(np.mean(eps_l)),
            "epochs_lirs_per_seed": eps_l,
            "acc_tfip": float(np.mean(acc_t)),
            "acc_lirs": float(np.mean(acc_l)),
            "acc_improvement": float(np.mean(acc_l) - np.mean(acc_t)),
            "val_traj_tfip": trajs[0],
            "val_traj_lirs": trajs[1],
        }
    return out


def queue_sweep(n: int = N, queues=QUEUES, epochs: int = SWEEP_EPOCHS, seeds=SEEDS,
                hidden=(64,), gather: str = "block", device="cuda",
                init: Optional[Init] = None) -> dict:
    """``queue_size.compute``: test accuracy for each TFIP queue size and
    for LIRS (≡ queue = N), with the queue's memory."""
    xs, ys, centers = make_clustered_data(n, DIM, CLASSES, seed=42, class_sorted=True, spread=1.0)
    xte, yte, _ = make_clustered_data(4000, DIM, CLASSES, seed=99, class_sorted=False,
                                      centers=centers)
    table = DeviceTable(xs, ys, device, gather)
    test = _on(table.device, xte, yte)
    ntr = len(table)

    def accs(make_shuffler):
        return [train(table, hidden, make_shuffler(seed), epochs, seed, init=init)
                .model.accuracy(*test) for seed in seeds]

    out = {}
    for q in queues:
        a = accs(lambda seed: TFIPShuffler(ntr, BATCH, queue_size=q, seed=seed))
        out[f"queue_{q}"] = {"acc_mean": float(np.mean(a)), "accs": a}
    a = accs(lambda seed: LIRSShuffler(ntr, BATCH, seed=seed))
    out["lirs_full"] = {"acc_mean": float(np.mean(a)), "accs": a}
    # memory cost of the queue (paper: 7.3 GB at Q=10000 for ImageNet)
    out["queue_memory_bytes"] = {f"queue_{q}": q * DIM * 4 for q in queues}
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=N, help="training rows (n // 20 per class)")
    p.add_argument("--queue", type=int, default=QUEUE, help="TFIP queue size")
    p.add_argument("--epochs", type=int, default=E_MAX)
    p.add_argument("--models", default=",".join(MODELS), help="comma-separated model names")
    p.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    p.add_argument("--gather", choices=GATHERS, default="block")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    unknown = set(a.models.split(",")) - set(MODELS)
    if unknown:
        p.error(f"unknown models {sorted(unknown)}; choose from {list(MODELS)}")
    out = compute(a.n, a.queue, a.epochs, {m: MODELS[m] for m in a.models.split(",")},
                  tuple(int(s) for s in a.seeds.split(",")), a.gather, a.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
