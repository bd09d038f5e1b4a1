#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and versions;
   exits non-zero without a CUDA device.
2. Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a, one process per source) and prints the build time and
   ptxas resource use.
3. Holds each kernel against its plain PyTorch version on the card:
   the attention kernels in bf16 and f32 at the serving path's shapes
   plus ragged ones and decode rows with ``cur >= T``; ``csr_dot``
   bit-exact (``torch.equal``) with both ``gather`` values at the SVM
   path's shape, a kddcup10-like one, a ragged B, duplicate ids and
   B = 0 (no launch).  Times the attention kernels, their plain versions
   and one PyTorch library call (``scaled_dot_product_attention``, a
   yardstick only: the port never calls it) and computes the least time
   the card could take.
4. Holds the port's model on the card against the same model on the CPU
   (plain kernel versions) at smoke size, in float32; and ``LinearSVM``
   likewise, a few steps on one dense batch at epsilon's width.
5. Drives the serving launcher (``repro_torch.launch.serve``) on
   granite-3-8b at full published width — random weights from ``--seed``,
   40 layers, d_model 4096 — and checks that every request completed, no
   slot leaked, and each kernel launched 40 times per prefill and per
   decode step (the warmup's included).
6. Profiles a few steady decode steps at full width (device time by
   kernel, device busy share).
7. Trains the sparse SVM at webspam width (16,609,143 features, rows cut
   to 12,500) as the JAX package's acceptance path does: record store →
   LIRS shuffler → multi-producer ragged pipeline → CSR packing → DCD,
   with the objective and held-out margins through ``csr_dot`` after
   each epoch; checks the batches, the falling objective, the margins
   against a host reference and the launch count; prints the host time
   split, the kernel's device time and the device's busy share; then
   times ``csr_dot`` on the path's training-set inputs against its plain
   version and ``embedding_bag``.
8. Prints ``{"kernels": [...]}``, then ``{"ok": true, "device": ...}`` as
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
F32_FLOPS = 67e12          # H100 SXM f32 on the CUDA cores
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}

# sparse SVM widths: Yu, Hsieh, Chang & Lin, "Large Linear Classification
# When Data Cannot Fit in Memory", KDD 2010, Table 2
WEBSPAM_DIM = 16_609_143   # webspam (trigram)
KDDCUP10_DIM = 29_890_095  # kddcup10
EPSILON_DIM = 2_000        # epsilon
SVM_TRAIN, SVM_TEST, SVM_BLOCK = 10_000, 2_500, 1_000  # rows cut from 350,000
SVM_NNZ = (2000, 5456)     # mean 3,728 nonzeros per row, as webspam's ~3,700
SVM_SWEEPS, SVM_EPOCHS = 3, 2

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
        **bound(nbytes, 4 * pairs * h * d, BF16_FLOPS), library_ms=t["library"],
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
        **bound(nbytes, 4 * used * h * d, BF16_FLOPS), library_ms=t["library"],
    ))
    print(f"  device ms per call: {t}; eager ms per call: {eager}; "
          f"bound {rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']})")

    print("csr_dot vs plain version (bit-exact, both gathers):")
    gg = torch.Generator(device=dev).manual_seed(1)
    for label, b, k, d in (("SVM path (webspam width)", SVM_TRAIN, SVM_NNZ[1], WEBSPAM_DIM),
                           ("kddcup10-like", 100_000, 56, KDDCUP10_DIM),
                           ("ragged B", 1001, 77, 1000)):
        idx = torch.randint(0, d, (b, k), generator=gg, device=dev, dtype=torch.int32)
        val = torch.randn(b, k, generator=gg, device=dev)
        keep = torch.randint(1, k + 1, (b, 1), generator=gg, device=dev)
        pad = torch.arange(k, device=dev)[None, :] >= keep  # pad_csr's zero suffix
        idx, val = idx.masked_fill(pad, 0), val.masked_fill(pad, 0.0)
        idx[0, : k // 2] = idx[0, 0]  # a row listing one id many times
        w = torch.randn(d, generator=gg, device=dev)
        want = ref.csr_dot(idx, val, w)
        for gather in ("take", "onehot"):
            got = ops.csr_dot(idx, val, w, gather=gather)
            torch.cuda.synchronize()
            check_equal(f"{label} ({b}x{k}, D={d}) gather={gather}", got, want)
    idx = torch.tensor([[3, 3, 0, 0], [5, 1, 5, 5]], dtype=torch.int32, device=dev)
    val = torch.tensor([[1.5, 2.5, 0.0, 0.0], [1.0, 2.0, 3.0, 4.0]], device=dev)
    w = torch.arange(8, dtype=torch.float32, device=dev)
    got = ops.csr_dot(idx, val, w)
    check(got.tolist() == [12.0, 42.0], f"duplicate ids: {got.tolist()}, want [12.0, 42.0]")
    before = ops.LAUNCHES["csr_dot"]
    empty = ops.csr_dot(idx[:0], val[:0], w)
    check(empty.shape == (0,) and ops.LAUNCHES["csr_dot"] == before, "B = 0 launched a kernel")
    print("  duplicate ids accumulate; B = 0 returns (0,) without a launch")
    return rows


def check_equal(label, got, want):
    same = torch.equal(got, want)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"  {label}: {'bit-exact' if same else 'DIFFERS'} (max_abs_err {err:.3e})")
    check(same, f"{label} not bit-exact")
    return err


def bound(nbytes, flops, peak_flops):
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / peak_flops
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


def linear_svm_phase(dev, steps=4):
    """LinearSVM on the card against the CPU: a few train_batch steps on
    one dense batch at epsilon's width, float32 with TF32 off."""
    import numpy as np

    from repro_torch.svm import LinearSVM

    print(f"LinearSVM on the card vs on the CPU ({EPSILON_DIM} features, float32):")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(512, EPSILON_DIM)).astype(np.float32)
    y = np.where(x @ rng.normal(size=EPSILON_DIM) > 0, 1.0, -1.0).astype(np.float32)
    models = {d: LinearSVM(EPSILON_DIM, lam=1e-4, lr=0.05, device=d) for d in ("cpu", dev)}
    losses = {d: torch.tensor([m.train_batch(x, y, inner_steps=2) for _ in range(steps)])
              for d, m in models.items()}
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    cpu, gpu = models["cpu"], models[dev]
    compare(f"loss over {steps} steps", losses[dev], losses["cpu"], 1e-5)
    compare("w", gpu.w.cpu(), cpu.w, 1e-5)
    compare("b", gpu.b.cpu().reshape(1), cpu.b.reshape(1), 1e-5)
    check(losses["cpu"][-1] < losses["cpu"][0], "LinearSVM loss did not fall")


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


class _EventTimed:
    """Brackets every ``ops.csr_dot`` call of a scope with CUDA events, so
    the kernel's device time on the path is read off the card; the
    launch count stays the wrapper's own."""

    def __init__(self, ops):
        self.ops, self.pairs = ops, []

    def __enter__(self):
        inner = self.inner = self.ops.csr_dot

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kw)
            stop.record()
            self.pairs.append((start, stop))
            return out

        self.ops.csr_dot = timed
        return self

    def __exit__(self, *exc):
        self.ops.csr_dot = self.inner

    def device_ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def svm_phase(dev, seed=0):
    """The sparse-SVM training path at webspam width, driven as the JAX
    package's acceptance test drives it; returns csr_dot's kernel row."""
    import tempfile

    import numpy as np
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (InputPipeline, LIRSShuffler, LocationGenerator,
                                  ReadPathConfig, build_data_plane)
    from repro_torch.data.synthetic import make_classification_dataset
    from repro_torch.kernels import ops, ref
    from repro_torch.obs import trace
    from repro_torch.storage import RaggedBufferRing, RecordStore
    from repro_torch.svm import pack_csr_batch, pad_csr
    from repro_torch.svm.dcd import DCDSolver

    n, dim = SVM_TRAIN + SVM_TEST, WEBSPAM_DIM
    print(f"sparse SVM at webspam width: D={dim}, {SVM_TRAIN} train + {SVM_TEST} held-out "
          f"rows, nnz {SVM_NNZ}, LIRS blocks of {SVM_BLOCK}, {SVM_SWEEPS} DCD sweeps, "
          f"{SVM_EPOCHS} epochs, seed {seed}")
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        meta = make_classification_dataset(
            os.path.join(tmp, "webspam.rrec"), n, dim, sparse=True,
            nnz_range=SVM_NNZ, noise=0.05, seed=seed)
        t_gen = time.perf_counter() - t0
        store = RecordStore(meta.path)
        loc = LocationGenerator().generate(store)
        train = pack_csr_batch(store.read_batch_ragged(np.arange(SVM_TRAIN)), dim)
        test = pack_csr_batch(store.read_batch_ragged(np.arange(SVM_TRAIN, n)), dim)
        print(f"  set-up: {meta.total_bytes / 1e6:.1f} MB of records written in {t_gen:.1f} s, "
              f"locations in {loc.build_seconds:.1f} s; mean nnz {train.nnz / SVM_TRAIN:.1f}")

        sh = LIRSShuffler(SVM_TRAIN, SVM_BLOCK, seed=seed)
        ring = RaggedBufferRing(SVM_BLOCK * (8 + 8 * SVM_NNZ[1]), SVM_BLOCK, depth=4)
        plane = build_data_plane(store, ReadPathConfig(mode="ragged", ring=ring, workers=4))
        solver = DCDSolver(dim, SVM_TRAIN, device=dev)
        host = {"dcd": 0.0, "pack": 0.0, "wait": 0.0}
        consumed, margin_calls, objs, accs = 0, 0, [], []

        ops.reset_launch_counts()
        with trace.tracing() as rec, _EventTimed(ops) as ev, \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for epoch in range(SVM_EPOCHS):
                # the shuffler's batches and the pipeline's items arrive in
                # the same order, so row j of a batch owns dual idx[j]
                idx_iter = sh.epoch_batches(epoch)
                pipe = InputPipeline(sh.epoch_batches, plane, prefetch=2,
                                     num_producers=2, recycle_fn=ring.recycle)
                for item in pipe.epoch(epoch):
                    idx = next(idx_iter)
                    t1 = time.perf_counter()
                    csr = pack_csr_batch(item, dim)
                    t2 = time.perf_counter()
                    solver.solve_block_csr(csr, idx, sweeps=SVM_SWEEPS)
                    host["pack"] += t2 - t1
                    host["dcd"] += time.perf_counter() - t2
                    consumed += len(csr)
                host["wait"] += pipe.stats.t_wait
                objs.append(solver.primal_objective_csr(train))
                margins = solver.margins_csr(test)
                margin_calls += 2
                accs.append(float((np.where(margins >= 0, 1.0, -1.0) == test.labels).mean()))
                print(f"  epoch {epoch}: primal objective {objs[-1]:.6f}, held-out accuracy "
                      f"{accs[-1]:.4f}, {time.perf_counter() - t0:.1f} s")
            train_acc = float((np.where(solver.margins_csr(train) >= 0, 1.0, -1.0)
                               == train.labels).mean())
            margin_calls += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["csr_dot"]
        kernel_ms = ev.device_ms()
        spans = {}
        for e in rec.drain():
            if e["ph"] == "X":
                spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        check(bool(events), "the profiler recorded no device activity")
        busy_s = sum(e.self_device_time_total for e in events) / 1e6

        print(f"  phase wall {wall:.2f} s over {SVM_EPOCHS} epochs; host: DCD {host['dcd']:.2f} s, "
              f"CSR packing {host['pack']:.2f} s, pad_csr {spans.get('svm/pad', 0):.2f} s, "
              f"host-to-device copy {spans.get('svm/h2d', 0):.2f} s, csr_dot call and "
              f"copy back {spans.get('svm/csr_dot', 0):.2f} s, waiting on reads "
              f"{host['wait']:.2f} s")
        print(f"  csr_dot: {launches} launches, {kernel_ms:.3f} ms on the device (CUDA "
              f"events); device busy {busy_s * 1e3:.1f} ms, busy share {busy_s / wall:.5f}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d} calls  {e.key[:90]}")
        print(f"  training accuracy {train_acc:.4f}; held-out accuracy by epoch {accs}")

        check(consumed == SVM_EPOCHS * SVM_TRAIN,
              f"consumed {consumed} rows, want {SVM_EPOCHS * SVM_TRAIN}")
        check(all(np.isfinite(objs)) and objs[1] < objs[0],
              f"objective did not fall from epoch 1 to 2: {objs}")
        check(train_acc > 0.99, f"training accuracy {train_acc}")
        check(launches == margin_calls,
              f"csr_dot launched {launches} times for {margin_calls} margins_csr calls")
        # the held-out margins against a host f64 CSR product of the same
        # f32 weights: the kernel's f32 sum of |terms| bounds the error
        rows = np.repeat(np.arange(len(test)), np.diff(test.row_ptr))
        w32 = solver.w.astype(np.float32).astype(np.float64)
        terms = test.values.astype(np.float64) * w32[test.indices]
        host_m = np.bincount(rows, terms, minlength=len(test))
        scale = np.bincount(rows, np.abs(terms), minlength=len(test))
        check(bool((np.abs(margins - host_m) <= 1e-5 * scale).all()),
              "held-out margins disagree with the host CSR product")
        host_acc = float((np.where(host_m >= 0, 1.0, -1.0) == test.labels).mean())
        print(f"  held-out margins match the host f64 product; accuracy from host margins "
              f"{host_acc:.4f}")

        # csr_dot timed on the path's training-set call
        idx2d, val2d = pad_csr(train)
        idx, val = torch.from_numpy(idx2d).to(dev), torch.from_numpy(val2d).to(dev)
        w = torch.from_numpy(solver.w.astype(np.float32)).to(dev)
        err = check_equal(f"training-set call {tuple(idx.shape)}", ops.csr_dot(idx, val, w),
                          ref.csr_dot(idx, val, w))
        w2 = w[:, None]
        t, eager = time_ms({
            "kernel": lambda: ops.csr_dot(idx, val, w),
            "plain": lambda: ref.csr_dot(idx, val, w),
            "library": lambda: F.embedding_bag(idx, w2, per_sample_weights=val, mode="sum")[:, 0],
        }, n=20)
        lib_err = float((F.embedding_bag(idx, w2, per_sample_weights=val, mode="sum")[:, 0]
                         - ref.csr_dot(idx, val, w)).abs().max())
        b, k = idx.shape
        distinct = int(torch.unique(idx).numel())
        nbytes = 8 * b * k + 4 * distinct + 4 * b
        row = dict(name="csr_dot", route="cuda", source="src/repro_torch/kernels/csrc/csr_dot.cu",
                   replaces="src/repro/kernels/csr_dot.py:88", launches=launches,
                   max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                   **bound(nbytes, 2 * b * k, F32_FLOPS), library_ms=t["library"])
        print(f"  device ms per call: {t}; eager ms per call: {eager}; {distinct} distinct ids; "
              f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}); embedding_bag's "
              f"max_abs_err {lib_err:.3e}")
        store.close()
    return row


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
    linear_svm_phase(dev)
    launches = serve_phase()
    profile_phase(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    rows.append(svm_phase(dev))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
