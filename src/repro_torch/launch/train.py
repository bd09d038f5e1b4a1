"""Training launcher of the port: a synthetic token corpus in a
RecordStore → shuffle strategy (LIRS / BMF / TFIP / CorgiPile / Corgi²) →
prefetching pipeline → train step on the card → checkpoints + Eq. 1
report.

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --seq-len 4096 --batch 1 --num-records 64 --epochs 1 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --smoke --device cpu --steps 4

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --smoke --device cpu --num-records 16 --seq-len 32 --batch 1 \\
        --epochs 2 --cache-mb 0.001 --prefetch-lookahead 4 \\
        --eviction-policy belady --drift-device optane

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --smoke --device cpu --num-records 32 --seq-len 32 --batch 4 \\
        --epochs 3 --hosts 4 --cache-mb 0.00201416015625 --prefetch-lookahead 2

The flags and summary are those of ``repro.launch.train``, plus
``--device`` (``cuda`` by default; asking for CUDA without one raises).
The summary adds the device, each step's loss and host-clock seconds
(ending in the sync that reads the loss), the device's peak memory and,
through a tier, the storage records each completed epoch read
(``storage_records_by_epoch``).
``--cache-mb > 0`` reads through the tiered DRAM path (clairvoyant
prefetch along the shuffler's index stream; batch bytes unchanged) and
adds the summary's ``cache`` block, and, over two or more epochs, the
``drift`` block (``--drift-device`` also prices the reads through a
Table 2 device model).  ``--hosts N`` with ``--cache-mb > 0`` runs the
data plane as an N-host clairvoyant cluster in this process
(:func:`repro_torch.prefetch.distributed.make_cluster`, the budget split
evenly): each host serves its slice of every global batch, peers before
storage, and the summary's ``distributed`` block replaces ``cache``.
Compute stays on the one device.  ``--hosts > 1`` without ``--cache-mb``
raises ``ValueError`` (the JAX launcher quietly runs one host).  A
config with an encoder (whisper-tiny) fails at its first step with an
error naming ``encoder_frames``, which the record batches do not carry
(the JAX launcher fails there too).
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.readpath import build_data_plane
from repro_torch.data.synthetic import decode_token_batch, make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.args import (
    add_read_path_args,
    config_from_args,
    make_shuffler_from_args,
    planner_from_args,
)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.storage.faults import FaultInjector, FaultSpec
from repro_torch.storage.record_store import IOStats, RecordStore
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
                    help="run the data plane as an N-host clairvoyant "
                         "cluster (repro_torch.prefetch.distributed): each "
                         "host owns a slice of every global batch, caches "
                         "what it consumes, and serves peers host-to-host "
                         "before storage.  Batches stay byte-identical to "
                         "--hosts 1; compute is unchanged (single device). "
                         "Needs --cache-mb > 0 (with --hosts > 1 the "
                         "budget is the FLEET budget, split evenly)")
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
                         "latency histograms) as JSON here at exit")
    ap.add_argument("--drift-device", default="",
                    choices=["", "hdd", "ssd", "optane"],
                    help="also price measured vs modeled storage reads "
                         "through this Table 2 device model in the drift "
                         "report (needs --cache-mb > 0)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _check_hosts(args) -> None:
    if args.hosts < 1:
        raise ValueError("--hosts must be >= 1")
    if args.hosts > 1 and args.cache_mb <= 0:
        raise ValueError(
            "--hosts > 1 runs the multi-host tier, which needs --cache-mb > 0 "
            "(the fleet's DRAM budget)"
        )


def main(argv=None):
    args = build_argparser().parse_args(argv)
    _check_hosts(args)
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
        summary = _train(args, cfg, device, path, store, injector, registry)
    finally:
        store.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(summary, indent=1))
    return summary


def _train(args, cfg, device, path, store, injector, registry):
    seq = args.seq_len
    shuffler = make_shuffler_from_args(args, store, args.batch, args.seed)
    fetcher = None
    cluster = None
    batch_iter_fn = None
    if args.cache_mb > 0 and args.hosts > 1:
        # distributed clairvoyant data plane: H in-process hosts, each
        # with its own store handle, shard view and cache; misses route
        # to the predicted holding peer before storage.  Compute stays on
        # this device: only the I/O plane is multi-host
        from repro_torch.prefetch.distributed import ClusterFetcher, make_cluster

        cluster = make_cluster(
            lambda: RecordStore(path, fault_injector=injector, verify=args.verify_checksums),
            shuffler,
            args.hosts,
            budget_bytes=int(args.cache_mb * 2**20),
            lookahead=args.prefetch_lookahead,
            workers=args.io_workers,
            background=True,
            max_epochs=args.epochs,
            policy=args.eviction_policy,
            planner=planner_from_args(args),
        )
        fetcher = ClusterFetcher(cluster)
        batch_iter_fn = fetcher.batch_iter
    elif args.cache_mb > 0:
        # tiered read path: DRAM cache + clairvoyant prefetch along the
        # shuffler's known index stream (batch bytes unchanged).
        # max_epochs stops the lookahead from prefetching past the last
        # epoch (reads nobody would consume, stalling shutdown)
        fetcher = build_data_plane(
            store,
            config_from_args(args, shuffler=shuffler, max_epochs=args.epochs),
        )
        batch_iter_fn = fetcher.batch_iter
    if fetcher is not None:
        if store.variable:
            def fetch(idx):
                return decode_token_batch(fetcher(idx).tolist(), seq)
        else:
            def fetch(idx):
                return decode_token_batch(fetcher(idx), seq)
    elif store.variable:
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

    # per-epoch counter snapshots for the drift report: cumulative at each
    # epoch end, so adjacent deltas give per-epoch (steady-state) windows
    epoch_snaps: list = []

    def epoch_hook(epoch):
        epoch_snaps.append(
            cluster.aggregate_io() if cluster is not None else store.stats.snapshot()
        )

    try:
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
            batch_iter_fn=batch_iter_fn,
            epoch_hook=epoch_hook,
            device=device,
        )
        obs_metrics.bind_store(registry, store)
        obs_metrics.bind_pipeline(registry, trainer.pipeline)
        if cluster is not None:
            obs_metrics.bind_cluster(registry, cluster)
        elif fetcher is not None:
            obs_metrics.bind_fetcher(registry, fetcher)
        if injector is not None:
            obs_metrics.bind_fault_log(registry, injector.log)
        if args.resume and trainer.try_resume():
            print(f"resumed at step {trainer.global_step}")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        summary = trainer.train()
    finally:
        if fetcher is not None:
            fetcher.close()
    if cluster is not None:
        summary["distributed"] = {
            "hosts": cluster.num_hosts,
            "policy": args.eviction_policy,
            "fleet_capacity_records": cluster.placement.aggregate_capacity(),
            "expected_steady_storage_records_per_epoch": (
                cluster.placement.expected_storage_reads()
            ),
            **cluster.aggregate_io(),
        }
    elif fetcher is not None:
        summary["cache"] = _cache_block(fetcher)
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
    # model-vs-measured drift over the steady (warm) epochs: the cold
    # first epoch is all misses by construction, so it only anchors the
    # delta window
    if fetcher is not None:
        key = "storage_records" if cluster is not None else "batch_records"
        ends = [snap[key] for snap in epoch_snaps]
        summary["storage_records_by_epoch"] = [b - a for a, b in zip([0] + ends, ends)]
    if len(epoch_snaps) >= 2 and fetcher is not None:
        report = (
            _distributed_drift_report(args, store, cluster, epoch_snaps)
            if cluster is not None
            else _drift_report(args, store, fetcher, epoch_snaps)
        )
        summary["drift"] = report.to_dict()
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


def _cache_block(fetcher) -> dict:
    """The summary's ``cache`` block, field for field the JAX launcher's."""
    cache, sched = fetcher.cache, fetcher.scheduler
    return {
        "policy": cache.policy,
        "planner": fetcher.planner,
        "budget_bytes": cache.budget_bytes,
        "used_bytes": cache.used_bytes,
        "demand_hits": cache.hits,
        "demand_misses": cache.misses,
        "window_hits": sched.window_hits,
        "prefetched_records": fetcher.prefetch_records,
        "rejected_inserts": cache.rejected,
        "planned_skips": cache.planned_skips,
        "doomed_records": sched.doomed_records,
        "probe_skips": fetcher.probe_skips,
        "stray_unpins": cache.stray_unpins,
        "scratch_copies": cache.scratch_copies,
        "invalidations": cache.invalidations,
        "plans_failed": fetcher.plans_failed,
        "worker_restarts": fetcher.worker_restarts,
    }


def _drift_report(args, store, fetcher, epoch_snaps):
    """The single-host drift report over the epochs after the first."""
    from repro_torch.obs import drift

    n = store.num_records
    d = IOStats.delta(epoch_snaps[-1], epoch_snaps[0])
    return drift.single_host_report(
        n_records=n,
        record_bytes=store.record_size or 0,
        capacity_frac=min(1.0, fetcher.cache.capacity / n),
        policy=args.eviction_policy,
        planner_on=bool(fetcher.planner),
        window_frac=min(1.0, args.prefetch_lookahead * args.batch / n),
        batch_frac=min(1.0, args.batch / n),
        epochs=len(epoch_snaps) - 1,
        storage_records=d["batch_records"],
        storage_ios=d["batch_ios"],
        storage_bytes=d["bytes_read"],
        device=args.drift_device or None,
    )


def _distributed_drift_report(args, store, cluster, epoch_snaps):
    """The fleet's drift report over the epochs after the first."""
    from repro_torch.obs import drift

    n = store.num_records
    first, last = epoch_snaps[0], epoch_snaps[-1]
    d = {k: last[k] - first[k] for k in last}
    return drift.distributed_report(
        n_records=n,
        hosts=args.hosts,
        capacity_frac_global=min(1.0, cluster.placement.aggregate_capacity() / n),
        policy=args.eviction_policy,
        window_frac=min(1.0, args.prefetch_lookahead * args.batch / n),
        epochs=len(epoch_snaps) - 1,
        remote_hits=d["remote_hits"],
        storage_records=d["storage_records"],
        local_hits=d["local_hits"],
    )


if __name__ == "__main__":
    main()
