"""Serving launcher of the port: offered-load driver over the
continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
        --max-batch 8 --prompt-capacity 128 --gen 32 --requests 16 \\
        --offered-load 1.0                       # on the GPU (default)
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The flags and report fields are those of ``repro.launch.serve``, plus
``--device`` (``cuda`` by default; asking for CUDA without one raises).
The report adds the device, the prefill count, slot leaks, host-clock
milliseconds per decode step and per prefill (each ending at the
engine's sync), and the device's peak memory.  With ``--cache-mb > 0``
each request's Zipf-popular feature ids are served through the
estimated-reuse :class:`~repro_torch.serve.reuse.RequestStreamCache`
(host memory, ``--eviction-policy`` from the shared read-path flags)
over a synthetic fixed-size feature store, and the report's
``feature_cache`` block holds the measured hit rate beside the
closed-form :func:`~repro_torch.storage.devices.served_hit_model` band:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --cache-mb 0.01 --num-features 512 --features-per-request 8
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.args import add_read_path_args
from repro_torch.models import model as M
from repro_torch.serve import (
    RequestStreamCache,
    ServeEngine,
    percentile,
    synthetic_workload,
)
from repro_torch.storage.devices import served_hit_model, zipf_popularity
from repro_torch.storage.record_store import RecordStore


def build_argparser():
    ap = argparse.ArgumentParser()
    add_read_path_args(ap)
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--serve-mode", default="continuous",
                    choices=["continuous", "static"],
                    help="continuous = in-flight batching (free slots "
                         "refill mid-decode); static = classic "
                         "run-to-completion batches")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="generation slots in the decode arena")
    ap.add_argument("--prompt-capacity", type=int, default=8,
                    help="prompt positions per slot (prompts right-pad "
                         "to this)")
    ap.add_argument("--gen", type=int, default=10,
                    help="generation positions per slot; the arena is "
                         "sized once from prompt-capacity + gen")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--offered-load", type=float, default=0.6,
                    help="mean request arrivals per engine step (Poisson)")
    ap.add_argument("--num-features", type=int, default=512,
                    help="feature-store records behind the request stream")
    ap.add_argument("--features-per-request", type=int, default=8)
    ap.add_argument("--zipf-alpha", type=float, default=1.1)
    ap.add_argument("--feature-data", default="",
                    help="existing fixed-size RecordStore to serve "
                         "features from (default: synthesize one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(vocab_size=min(cfg.vocab_size, 512))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device)

    store, tmp = None, None
    try:
        if args.cache_mb > 0:
            if args.feature_data:
                path = args.feature_data
            else:
                tmp = tempfile.mkdtemp(prefix="lirs_serve_")
                path = make_classification_dataset(
                    f"{tmp}/features.rrec", args.num_features, dim=16,
                    seed=args.seed,
                ).path
            store = RecordStore(path)
        report = _serve(args, cfg, params, device, store)
    finally:
        if store is not None:
            store.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report, indent=1))
    return report


def _serve(args, cfg, params, device, store):
    feature_cache = None
    if store is not None:
        feature_cache = RequestStreamCache(
            store,
            budget_bytes=int(args.cache_mb * 2**20),
            policy=args.eviction_policy,
        )

    requests = synthetic_workload(
        args.requests,
        vocab=cfg.vocab_size,
        offered_load=args.offered_load,
        prompt_len=(max(1, args.prompt_capacity // 2), args.prompt_capacity),
        gen_len=(max(1, args.gen // 2), args.gen),
        num_features=args.num_features if feature_cache is not None else 0,
        features_per_request=(
            args.features_per_request if feature_cache is not None else 0
        ),
        zipf_alpha=args.zipf_alpha,
        seed=args.seed,
    )

    engine = ServeEngine(
        cfg, params,
        max_batch=args.max_batch,
        prompt_capacity=args.prompt_capacity,
        max_new_tokens=args.gen,
        mode=args.serve_mode,
        feature_cache=feature_cache,
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    engine.warmup()
    tokens_before = engine.generated_tokens
    t0 = time.perf_counter()
    completions = engine.run(requests)
    wall = time.perf_counter() - t0
    tokens = engine.generated_tokens - tokens_before

    lat = [c.latency for c in completions]
    ttft = [c.ttft for c in completions]
    report = {
        "arch": cfg.name,
        "serve_mode": args.serve_mode,
        "max_batch": args.max_batch,
        "requests": len(completions),
        "offered_load": args.offered_load,
        "generated_tokens": tokens,
        "decode_steps": engine.decode_steps,
        "tokens_per_step": round(tokens / max(engine.decode_steps, 1), 3),
        "tokens_per_s": round(tokens / max(wall, 1e-9), 1),
        "latency_p50_steps": round(percentile(lat, 50), 2),
        "latency_p99_steps": round(percentile(lat, 99), 2),
        "ttft_p50_steps": round(percentile(ttft, 50), 2),
        "ttft_p99_steps": round(percentile(ttft, 99), 2),
    }
    if feature_cache is not None:
        capacity = feature_cache.cache.capacity
        pop = zipf_popularity(args.num_features, args.zipf_alpha)
        report["feature_cache"] = {
            "policy": args.eviction_policy,
            "capacity_records": capacity,
            "hits": feature_cache.cache.hits,
            "misses": feature_cache.cache.misses,
            "hit_rate": round(feature_cache.hit_rate, 4),
            "model_lru": round(served_hit_model(pop, capacity, "lru"), 4),
            "model_clairvoyant": round(
                served_hit_model(pop, capacity, "belady"), 4
            ),
            "storage_cache_hits": store.stats.cache_hits,
            "storage_records_read": store.stats.batch_records,
        }
    report.update({
        "device": str(device),
        "prefills": engine.prefills,
        "slot_leaks": engine.max_batch - engine.free_slots,
        "decode_ms_per_step": 1e3 * engine.decode_seconds / max(engine.decode_steps, 1),
        "prefill_ms_per_request": 1e3 * engine.prefill_seconds / max(engine.prefills, 1),
        "peak_memory_gib": (
            torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None
        ),
    })
    return report


if __name__ == "__main__":
    main()
