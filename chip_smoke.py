#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and versions;
   exits non-zero without a CUDA device.
2. Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a) and prints the build time and ptxas resource use.
3. Holds each kernel against its plain PyTorch version on the card, in
   bf16 and f32, at the serving path's shapes plus ragged ones and decode
   rows with ``cur >= T``; times kernel, plain version and one PyTorch
   library call (``scaled_dot_product_attention``, a yardstick only: the
   port never calls it) and computes the least time the card could take.
4. Holds the port's model on the card against the same model on the CPU
   (plain kernel versions) at smoke size, in float32.
5. Drives the serving launcher (``repro_torch.launch.serve``) on
   granite-3-8b at full published width — random weights from ``--seed``,
   40 layers, d_model 4096 — and checks that every request completed, no
   slot leaked, and each kernel launched 40 times per prefill and per
   decode step (the warmup's included).
6. Profiles a few steady decode steps at full width (device time by
   kernel, device busy share).
7. Prints ``{"kernels": [...]}``, then ``{"ok": true, "device": ...}`` as
   the last line.  Any failed check exits non-zero before those lines.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}

SERVE_ARGS = ["--arch", "granite-3-8b", "--serve-mode", "continuous",
              "--max-batch", "8", "--prompt-capacity", "128", "--gen", "32",
              "--requests", "16", "--offered-load", "1.0", "--seed", "0",
              "--device", "cuda"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def compare(label, got, want, tol):
    """max |got - want| and whether every element is within
    tol + tol·|want| (numpy's allclose with rtol = atol = tol)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    max_err = float(err.max())
    print(f"  {label}: max_abs_err {max_err:.3e} (tol {tol:g}) {'ok' if ok else 'BREACH'}")
    check(ok, f"{label} outside tolerance")
    return max_err


def time_ms(fns, n=50, rounds=3):
    """Device time per call: each function's n calls are captured in one
    CUDA graph, so the Python wrappers' host time drops out, and the
    graph replays are timed with CUDA events.  Median over rounds; the
    functions take turns (a b c, c b a, a b c) on one card.  Also returns
    the eager per-call time (host and device, as the serve loop sees it)."""
    graphs, eager = {}, {}
    for k, f in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            f()
        torch.cuda.current_stream().wait_stream(side)
        graphs[k] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[k]):
            for _ in range(n):
                f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        torch.cuda.synchronize()
        eager[k] = 1e3 * (time.perf_counter() - t0) / n
    samples = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[k].replay()
            stop.record()
            torch.cuda.synchronize()
            samples[k].append(start.elapsed_time(stop) / n)
    return {k: statistics.median(v) for k, v in samples.items()}, eager


# ------------------------------------------------------------ kernels


def kernel_phase(dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(0)

    def randn(*shape, dt):
        return torch.randn(*shape, generator=g).to(dev, dt)

    rows = []
    print("flash_attention vs plain version:")
    for dt in (torch.bfloat16, torch.float32):
        for p, causal in ((128, True), (200, True), (200, False)):
            q, k, v = randn(1, p, 32, 128, dt=dt), randn(1, p, 8, 128, dt=dt), randn(1, p, 8, 128, dt=dt)
            got = ops.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            compare(f"{dt} q{tuple(q.shape)} kv{tuple(k.shape)} causal={causal}",
                    got, ref.flash_attention(q, k, v, causal), TOL[str(dt)])

    # the prefill path's shape and dtype: one admitted 128-token prompt
    dt = torch.bfloat16
    q, k, v = randn(1, 128, 32, 128, dt=dt), randn(1, 128, 8, 128, dt=dt), randn(1, 128, 8, 128, dt=dt)
    err = compare("timed inputs", ops.flash_attention(q, k, v), ref.flash_attention(q, k, v), 2e-2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t, eager = time_ms({
        "kernel": lambda: ops.flash_attention(q, k, v),
        "plain": lambda: ref.flash_attention(q, k, v),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
    })
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    pairs = s * (s + 1) // 2
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:104",
        max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
        **bound(nbytes, 4 * pairs * h * d), library_ms=t["library"],
    ))
    print(f"  device ms per call: {t}; eager ms per call: {eager}; "
          f"bound {rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']})")

    print("flash_decode vs plain version:")
    c = 160  # the arena: prompt capacity 128 + 32 generated
    cur = torch.tensor([0, 17, 31, 32, 100, c - 1, c, c + 11], dtype=torch.int32, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        q, kc, vc = randn(8, 32, 128, dt=dt), randn(8, c, 8, 128, dt=dt), randn(8, c, 8, 128, dt=dt)
        got = ops.flash_decode(q, kc, vc, cur)
        torch.cuda.synchronize()
        compare(f"{dt} q{tuple(q.shape)} cache{tuple(kc.shape)} cur={cur.tolist()}",
                got, ref.flash_decode(q, kc, vc, cur), TOL[str(dt)])
    dt = torch.bfloat16
    q, kc, vc = randn(8, 32, 128, dt=dt), randn(8, c, 8, 128, dt=dt), randn(8, c, 8, 128, dt=dt)
    err = compare("timed inputs", ops.flash_decode(q, kc, vc, cur), ref.flash_decode(q, kc, vc, cur), 2e-2)
    q4 = q[:, :, None]                                     # (B,H,1,D)
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))  # (B,K,T,D)
    mask = (torch.arange(c, device=dev)[None, :] <= cur[:, None])[:, None, None, :]
    t, eager = time_ms({
        "kernel": lambda: ops.flash_decode(q, kc, vc, cur),
        "plain": lambda: ref.flash_decode(q, kc, vc, cur),
        "library": lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True),
    })
    used = int((cur.clamp(max=c - 1) + 1).sum())  # cache positions read
    kh, d, h = kc.shape[2], kc.shape[3], q.shape[1]
    nbytes = 2 * (2 * q.numel() + 2 * used * kh * d) + 4 * cur.numel()
    rows.append(dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:91",
        max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
        **bound(nbytes, 4 * used * h * d), library_ms=t["library"],
    ))
    print(f"  device ms per call: {t}; eager ms per call: {eager}; "
          f"bound {rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']})")
    return rows


def bound(nbytes, flops):
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / BF16_FLOPS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


# ---------------------------------------------------- model, small size


def model_phase(dev):
    """The port on the card (kernels) against the port on the CPU (plain
    versions), smoke granite, same weights and inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    # float32: the point is the algorithm, and bf16 matrix products round
    # differently on the card and the CPU (the kernels' bf16 results are
    # held to their plain versions on the card above)
    print("model on the card vs on the CPU (smoke granite, float32):")
    cfg = get_config("granite-3-8b", smoke=True).replace(dtype="float32")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    gpu = M.tree_map(lambda x: x.to(dev), cpu)
    toks = torch.randint(1, cfg.vocab_size, (1, 37), generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([29], dtype=torch.int32)
    outs = {}
    for name, params, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        arena = M.init_decode_cache(cfg, 4, 48, d, pos=torch.tensor([0, 5, 47, 60]))
        pre, plog = M.prefill_at(cfg, params, toks.to(d), lens.to(d))
        arena = M.write_prefill_slot(cfg, arena, 0, pre)
        arena, dlog = M.decode_step_slots(cfg, params, arena, torch.full((4, 1), 7, device=d))
        outs[name] = (plog, dlog)
    for i, what in enumerate(("prefill_at logits", "decode_step_slots logits")):
        want, got = outs["cpu"][i], outs["gpu"][i].cpu()
        check(got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}")
        compare(f"{what} {tuple(got.shape)}", got, want, 1e-4)


# ------------------------------------------------------- the main path


def serve_phase():
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    print("serving granite-3-8b at full width:", " ".join(SERVE_ARGS))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = serve.main(SERVE_ARGS)
    launches = dict(ops.LAUNCHES)
    print(f"  serve run incl. init {time.perf_counter() - t0:.1f} s; launches {launches}")
    layers = get_config("granite-3-8b").num_layers  # 40
    check(report["arch"] == "granite-3-8b", "not the full-width config")
    check(report["requests"] == 16, f"{report['requests']} of 16 requests completed")
    check(report["slot_leaks"] == 0, f"{report['slot_leaks']} slots leaked")
    want_fa = layers * (report["prefills"] + 1)
    want_fd = layers * (report["decode_steps"] + 1)
    check(launches["flash_attention"] == want_fa,
          f"flash_attention launched {launches['flash_attention']} times, want {want_fa}")
    check(launches["flash_decode"] == want_fd,
          f"flash_decode launched {launches['flash_decode']} times, want {want_fd}")
    return launches


def profile_phase(dev, steps=5):
    """Where a steady decode step's time goes: all 8 slots live at full
    width, ``steps`` engine steps under torch.profiler; prints device time
    by kernel, device time per step and the device's busy share of the
    wall time.  Runs after the main path, so its launches are not counted
    there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("granite-3-8b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, max_batch=8, prompt_capacity=128, max_new_tokens=32)
    eng.warmup()
    rng = torch.Generator().manual_seed(3)
    for rid in range(8):
        prompt = torch.randint(1, cfg.vocab_size, (100,), generator=rng).numpy().astype("int32")
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=32))
    eng.step()  # admits all 8 and decodes once
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(eng.active == 8, "profiled steps lost a slot")
    # device-side events only (kernels, copies): the CPU ops that launch
    # them carry the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    check(bool(events), "the profiler recorded no device activity")
    device_us = sum(e.self_device_time_total for e in events)
    print(f"profile of {steps} decode steps (8 live slots, full width): "
          f"wall {1e3 * wall / steps:.2f} ms/step, device busy "
          f"{1e-3 * device_us / steps:.2f} ms/step, busy share "
          f"{1e-6 * device_us / wall:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib}")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    rows = kernel_phase(dev)
    model_phase(dev)
    launches = serve_phase()
    profile_phase(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
