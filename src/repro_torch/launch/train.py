"""Training launcher of the port: a synthetic token corpus in a
RecordStore → shuffle strategy (LIRS / BMF / TFIP / CorgiPile / Corgi²) →
prefetching pipeline → train step on the card → checkpoints + Eq. 1
report.

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --seq-len 4096 --batch 1 --num-records 64 --epochs 1 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --smoke --device cpu --steps 4

The flags and summary are those of ``repro.launch.train``, plus
``--device`` (``cuda`` by default; asking for CUDA without one raises).
The summary adds the device, each step's loss and host-clock seconds
(ending in the sync that reads the loss) and the device's peak memory.  The tiered
read path (``--cache-mb > 0``), its multi-host cluster (``--hosts > 1``)
and the drift report (``--drift-device``) are not ported yet and are
refused, so the summary has no ``cache``, ``distributed`` or ``drift``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import decode_token_batch, make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.args import add_read_path_args, make_shuffler_from_args
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.storage.faults import FaultInjector, FaultSpec
from repro_torch.storage.record_store import RecordStore
from repro_torch.train.loop import Trainer, TrainLoopConfig
from repro_torch.train.optimizer import AdamWConfig


def build_argparser():
    ap = argparse.ArgumentParser()
    add_read_path_args(ap)
    ap.add_argument("--arch", default="recurrentgemma-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--num-records", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=0, help="cap total steps")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", default="", help="existing RecordStore path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--io-producers", type=int, default=1,
                    help="pipeline producer threads (ordered reassembly)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="N-host clairvoyant data plane (not ported yet: 1 only)")
    ap.add_argument("--chaos", default="",
                    help="fault-injection spec for the read path, e.g. "
                         "'seed=1,transient=0.05,stall=0.01,stall_s=0.2' "
                         "(see repro_torch.storage.faults.FaultSpec.parse); "
                         "empty = no injection")
    ap.add_argument("--verify-checksums", default="auto",
                    choices=["auto", "full", "off"],
                    help="RREC v2 payload verification: auto (only "
                         "retried/hedged extents — free on the clean "
                         "path), full (every record), off")
    ap.add_argument("--trace", default="",
                    help="record spans across the I/O stack and the train "
                         "step and write a Chrome trace-event JSON here at "
                         "exit (open it in Perfetto)")
    ap.add_argument("--metrics-json", default="",
                    help="dump the metrics-registry snapshot (counters, "
                         "gauges, latency histograms) as JSON here at exit")
    ap.add_argument("--drift-device", default="",
                    choices=["", "hdd", "ssd", "optane"],
                    help="drift report against a Table 2 device model "
                         "(needs the tiered read path; not ported yet)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _refuse_unported(args) -> None:
    for flag, on in (("--cache-mb > 0", args.cache_mb > 0), ("--hosts > 1", args.hosts > 1),
                     ("--drift-device", bool(args.drift_device))):
        if on:
            raise NotImplementedError(
                f"{flag} needs the tiered read path (DRAM cache, clairvoyant "
                "prefetch, multi-host plane), a later slice of the port; run "
                "with --cache-mb 0 --hosts 1"
            )


def main(argv=None):
    args = build_argparser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    if args.trace:
        obs_trace.enable()
    registry = obs_metrics.reset_registry()
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(vocab_size=min(cfg.vocab_size, 512))

    injector = FaultInjector(FaultSpec.parse(args.chaos)) if args.chaos else None
    tmp = None
    if args.data:
        path = args.data
    else:
        tmp = tempfile.mkdtemp(prefix="lirs_data_")
        path = make_token_dataset(
            f"{tmp}/corpus.rrec", args.num_records, args.seq_len,
            min(cfg.vocab_size, 512) if args.smoke else cfg.vocab_size,
            seed=args.seed,
        ).path
    store = RecordStore(path, fault_injector=injector, verify=args.verify_checksums)
    try:
        summary = _train(args, cfg, device, store, injector, registry)
    finally:
        store.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(summary, indent=1))
    return summary


def _train(args, cfg, device, store, injector, registry):
    seq = args.seq_len
    shuffler = make_shuffler_from_args(args, store, args.batch, args.seed)
    if store.variable:
        def fetch(idx):
            return decode_token_batch(
                store.read_batch_coalesced(idx, workers=args.io_workers), seq
            )
    else:
        # coalesced multi-queue hot path: dense buffer, zero-copy decode
        def fetch(idx):
            return decode_token_batch(
                store.read_batch_into(idx, workers=args.io_workers), seq
            )

    trainer = Trainer(
        cfg,
        fetch,
        shuffler,
        TrainLoopConfig(
            epochs=args.epochs, max_steps=args.steps, ckpt_dir=args.ckpt_dir,
            fail_at_step=args.fail_at_step, seed=args.seed,
        ),
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=10),
        num_producers=args.io_producers,
        device=device,
    )
    obs_metrics.bind_store(registry, store)
    obs_metrics.bind_pipeline(registry, trainer.pipeline)
    if injector is not None:
        obs_metrics.bind_fault_log(registry, injector.log)
    if args.resume and trainer.try_resume():
        print(f"resumed at step {trainer.global_step}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    summary = trainer.train()
    st = store.stats
    summary["io_resilience"] = {
        "verify": store.verify,
        "rrec_version": store.version,
        "retries": st.retries,
        "hedged_reads": st.hedged_reads,
        "checksum_failures": st.checksum_failures,
        "degraded_batches": st.degraded_batches,
    }
    if injector is not None:
        summary["io_resilience"]["injected"] = injector.counters()
    summary["device"] = str(device)
    summary["losses"] = [h["loss"] for h in trainer.history]
    summary["step_seconds"] = trainer.step_seconds
    summary["peak_memory_gib"] = (
        torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    )
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            f.write(registry.to_json(indent=1))
        summary["metrics_json"] = args.metrics_json
    if args.trace:
        rec = obs_trace.get_recorder()
        if rec is not None:
            doc = rec.export_chrome(args.trace)
            summary["trace"] = {"path": args.trace, "events": len(doc["traceEvents"])}
        obs_trace.disable()
    return summary


if __name__ == "__main__":
    main()
