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
8. Holds ``batch_gather`` and ``batch_gather_dma`` bit-exact against
   their plain version (f32/bf16/int32, rows_per_block 1-8,
   rows_per_step 1/8/16, ragged B, duplicate and out-of-range ids, B = 0
   without a launch) and times them, their plain version and
   ``index_select`` at the DNN path's shape and a 2 GiB bandwidth shape
   (this runs right after step 3).
9. Trains the paper's DNN workload (Tables 6-7) through
   ``repro_torch.dnn.convergence`` at ImageNet-1k's row count (1,281,160
   rows of 32 f32 features held on the card, vgg-like MLP, batch 100):
   TFIP with a 10,000 queue against LIRS, one epoch each, every batch
   gathered by ``batch_gather``; checks the rows consumed, two launches a
   step, the falling validation loss and LIRS's higher test accuracy;
   replays LIRS's first epoch with ``batch_gather_dma`` against the same
   step losses; checks one epoch of both shufflers' batches, gathered by
   both kernels, against ``xs[idx]`` on the host; prints the host time of
   TFIP's window shuffle and the device's busy share over 200 steps.
10. Holds ``rglru_scan`` and its backward ``rglru_scan_bwd`` bit-exact
   (``torch.equal``) against their plain versions at the training path's
   shape (1, 4096, 2560), a ragged one and T = 1, and times each
   direction against its plain loop (no single PyTorch call computes a
   linear recurrence, so there is no library time).  Then one train step
   of smoke recurrentgemma (float32) on the card against the same step on
   the CPU: loss, gradient norm and updated parameters (this runs after
   step 4's model check).
11. Trains recurrentgemma-2b at full width and depth through
   ``repro_torch.launch.train`` (seq 4096, batch 1, 8 steps, AdamW, remat
   per pattern period): checks 8 finite losses and 36 ``rglru_scan`` and
   18 ``rglru_scan_bwd`` launches a step (18 RG-LRU layers, each scan run
   forward and again in the recompute); prints Eq. 1's numbers, the step
   times and the peak memory; then profiles two steady steps (device time
   by kernel, busy share).
12. Prints ``{"kernels": [...]}``, then ``{"ok": true, "device": ...}`` as
   the last line.  Any failed check exits non-zero before those lines.
"""
from __future__ import annotations

import itertools
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

# the DNN path (paper Tables 6-7): the JAX benchmark's widths (DIM 32, 20
# classes, batch 100, "vgg-like" hidden widths) at the row count of the
# paper's DNN dataset, ImageNet-1k train; make_clustered_data keeps
# n // 20 rows per class, so the table holds 1,281,160 rows
IMAGENET_ROWS = 1_281_167
DNN_QUEUE = 10_000        # the paper's TFIP queue (benchmarks/dnn_convergence.py:21)
DNN_EPOCHS = 1            # reduced from E_MAX = 10 for time (a step costs ~3 ms of host)
DNN_MODEL = "vgg-like"
DNN_PROFILE_STEPS = 200
GATHER_BW = (1_048_576, 512, 8_192)  # bandwidth shape: a 2 GiB f32 table, B

# the LM training path: recurrentgemma-2b at published width and depth;
# seq 4096 is twice the local-attention window, so the chunked branch runs
TRAIN_ARGS = ["--arch", "recurrentgemma-2b", "--seq-len", "4096", "--batch", "1",
              "--num-records", "64", "--epochs", "1", "--steps", "8", "--seed", "0",
              "--device", "cuda"]
SCAN_SHAPES = ((1, 4096, 2560), (3, 1000, 2560 + 96), (2, 1, 2560))  # the path's first

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


def gather_kernel_phase(dev):
    """batch_gather (K1) and batch_gather_dma (K2) against ref.batch_gather,
    bit for bit, then timed at the DNN path's shape and a bandwidth shape;
    returns their kernel rows (launches are filled in by the DNN phase)."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(5)
    print("batch_gather / batch_gather_dma vs plain version (bit-exact):")
    cases = 0
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        for d, b in ((40, 37), (3, 61), (4100, 9)):  # ragged B; 16/4/2-byte words; 16 KB chunks
            full = torch.randn(1025, d, generator=g, device=dev).mul(1000).to(dt)
            table = full[1:]  # 1024 rows, off a 16-byte boundary where d·elt is not
            for r in (1, 2, 4, 8):
                nb = 1024 // r
                idx = torch.randint(-nb - 5, nb + 6, (b,), generator=g, device=dev,
                                    dtype=torch.int32)
                idx[:4] = idx[4]  # duplicates; the range puts ids outside the table
                want = ref.batch_gather(table, idx, r)
                # block_d = d: 4100 is no multiple of the default 512
                got = {"batch_gather": ops.batch_gather(table, idx, block_d=d, rows_per_block=r)}
                for m in (1, 8, 16):
                    got[f"batch_gather_dma m={m}"] = ops.batch_gather_dma(
                        table, idx, block_d=d, rows_per_block=r, rows_per_step=m)
                torch.cuda.synchronize()
                for name, out in got.items():
                    cases += 1
                    check(torch.equal(out, want),
                          f"{name} {dt} d={d} B={b} r={r} differs from the plain version")
    before = dict(ops.LAUNCHES)
    for fn in (ops.batch_gather, ops.batch_gather_dma):
        check(tuple(fn(table, idx[:0], block_d=d).shape) == (0, d), "B = 0 shape")
    check(ops.LAUNCHES == before, "B = 0 launched a kernel")
    print(f"  {cases} cases bit-exact (f32/bf16/int32, rows_per_block 1/2/4/8, rows_per_step "
          f"1/8/16, ragged B, duplicate and out-of-range ids); B = 0 launches nothing")

    rows = time_gathers(dev, g)
    torch.cuda.empty_cache()  # the 2 GiB table
    return rows


def time_gathers(dev, g):
    """Both gathers, their plain version and index_select at the DNN
    path's shape (one batch's features and labels) and a bandwidth shape.
    Each timed call gathers its own ids (one set per call of the graph),
    so the bandwidth shape's rows are not all in the 50 MB L2."""
    from repro_torch.kernels import ops, ref

    n, d, b = 20 * (IMAGENET_ROWS // 20), 32, 100
    x = torch.randn(n, d, generator=g, device=dev)
    y = torch.randint(0, 20, (n, 1), generator=g, device=dev, dtype=torch.int32)
    nbw, dbw, bbw = GATHER_BW
    big = torch.randn(nbw, dbw, generator=g, device=dev)
    shapes = [("DNN path: features + labels", (x, y), b, 1, 50),
              ("bandwidth r=1", (big,), bbw, 1, 50), ("bandwidth r=8", (big,), bbw, 8, 20)]
    rows = {}
    for label, tables, b, r, calls in shapes:
        nb = tables[0].shape[0] // r
        ids = [torch.randint(0, nb, (b,), generator=g, device=dev, dtype=torch.int32)
               for _ in range(calls)]

        def timed(f):
            it = itertools.cycle(ids)
            return lambda: f(next(it))

        def kernel(fn):
            return lambda i: [fn(t, i, rows_per_block=r) for t in tables]

        def plain(i):
            return [ref.batch_gather(t, i, r) for t in tables]

        def library(i):
            return [t.view(nb, r * t.shape[1]).index_select(0, i) for t in tables]

        want = plain(ids[0])
        errs = []
        for name in ("batch_gather", "batch_gather_dma"):
            got = kernel(getattr(ops, name))(ids[0])
            errs.append(max(check_equal(f"{label} {name}", o, w) for o, w in zip(got, want)))
        check(all(torch.equal(a.view(-1), w.view(-1)) for a, w in zip(library(ids[0]), want)),
              f"{label}: index_select differs from the plain version")
        t, eager = time_ms({
            "batch_gather": timed(kernel(ops.batch_gather)),
            "batch_gather_dma": timed(kernel(ops.batch_gather_dma)),
            "plain": timed(plain),
            "library": timed(library),
        }, n=calls)
        nbytes = sum(2 * b * r * tb.shape[1] * tb.element_size() + 4 * b for tb in tables)
        bnd = bound(nbytes, 0, F32_FLOPS)
        print(f"  {label}: B={b}, tables {[tuple(tb.shape) for tb in tables]}: device ms per "
              f"call {t}; eager ms per call {eager}; bound {bnd['bound_ms']:.6f} ms "
              f"({nbytes} bytes)")
        if label.startswith("DNN path"):
            for name, err in zip(("batch_gather", "batch_gather_dma"), errs):
                rows[name] = dict(
                    name=name, route="cuda", source="src/repro_torch/kernels/csrc/batch_gather.cu",
                    replaces=("src/repro/kernels/batch_gather.py:63" if name == "batch_gather"
                              else "src/repro/kernels/batch_gather.py:144"),
                    max_abs_err=err, ms=t[name], plain_ms=t["plain"], **bnd,
                    library_ms=t["library"])
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


def rglru_kernel_phase(dev):
    """rglru_scan (K5) and its reverse-time backward against their plain
    versions, bit for bit, then timed at the training path's shape;
    returns their kernel rows (launches are filled in by the training
    phase)."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(8)
    print("rglru_scan / rglru_scan_bwd vs plain versions (bit-exact):")
    inputs = {}
    for shape in SCAN_SHAPES:
        a = torch.rand(shape, generator=g, device=dev) * 0.4 + 0.6  # decays as the layer's
        x = torch.randn(shape, generator=g, device=dev)
        dh = torch.randn(shape, generator=g, device=dev)
        h = ops.rglru_scan(a, x)
        dx, da = ops.rglru_scan_bwd(a, h, dh)
        torch.cuda.synchronize()
        want_h = ref.rglru_scan(a, x)
        want_dx, want_da = ref.rglru_scan_bwd(a, want_h, dh)
        errs = {"rglru_scan": check_equal(f"forward {shape}", h, want_h),
                "rglru_scan_bwd": max(check_equal(f"backward dx {shape}", dx, want_dx),
                                      check_equal(f"backward da {shape}", da, want_da))}
        if not inputs:
            inputs = dict(a=a, x=x, dh=dh, h=h, errs=errs)
    a, x, dh, h = (inputs[k] for k in ("a", "x", "dh", "h"))
    b, t, w = a.shape
    rows = {}
    for name, kernel, plain, nbytes in (
        ("rglru_scan", lambda: ops.rglru_scan(a, x), lambda: ref.rglru_scan(a, x),
         3 * b * t * w * 4),  # a, x in; h out
        ("rglru_scan_bwd", lambda: ops.rglru_scan_bwd(a, h, dh),
         lambda: ref.rglru_scan_bwd(a, h, dh), 5 * b * t * w * 4),  # a, h, dh in; dx, da out
    ):
        tk, ek = time_ms({"kernel": kernel}, n=20)
        tp, ep = time_ms({"plain": plain}, n=1)  # a graph of T steps' small ops
        flops = (2 if name == "rglru_scan" else 3) * b * t * w
        rows[name] = dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
            replaces="src/repro/kernels/rglru_scan.py:58", max_abs_err=inputs["errs"][name],
            ms=tk["kernel"], plain_ms=tp["plain"], **bound(nbytes, flops, F32_FLOPS),
            library_ms=None)
        print(f"  {name} {tuple(a.shape)}: device ms per call kernel {tk['kernel']:.6f}, plain "
              f"{tp['plain']:.3f}; eager ms per call kernel {ek['kernel']:.6f}, plain "
              f"{ep['plain']:.3f}; bound {rows[name]['bound_ms']:.6f} ms ({nbytes} bytes, "
              f"{rows[name]['bound_by']}); no PyTorch call computes a linear recurrence")
    return rows


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


def train_step_phase(dev):
    """One train step (loss, autograd, AdamW) of smoke recurrentgemma in
    float32 on the card (the scan kernels) against the same step on the
    CPU (their plain versions), from the same weights and batch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("recurrentgemma-2b", smoke=True).replace(dtype="float32")
    print("train step on the card vs on the CPU (smoke recurrentgemma, float32, seq 32 > "
          f"window {cfg.local_window}):")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(6))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    init = init_train_state(cfg, torch.Generator().manual_seed(1), AdamW(opt_cfg), "cpu")
    outs = {}
    for d in ("cpu", dev):
        state = tree_map(lambda x: x.clone().to(d), init)
        before = dict(ops.LAUNCHES)
        state, out = make_train_step(cfg, AdamW(opt_cfg))(state, {k: v.to(d) for k, v in batch.items()})
        torch.cuda.synchronize()
        outs[d] = (state, {k: float(v) for k, v in out.items()},
                   {k: ops.LAUNCHES[k] - before[k] for k in before})
    (cs, co, _), (gs, go, glaunch) = outs["cpu"], outs[dev]
    rg = sum(p.count("rglru") * r for p, r in cfg.stages)
    check(glaunch["rglru_scan"] == 2 * rg and glaunch["rglru_scan_bwd"] == rg,
          f"scan launches {glaunch} for {rg} RG-LRU layers")
    for k, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        err = abs(go[k] - co[k]) / abs(co[k])
        print(f"  {k}: card {go[k]:.7f}, CPU {co[k]:.7f}, relative error {err:.2e} (tol {tol:g})")
        check(err <= tol, f"train step {k} differs")
    # The step's clipped gradients, from the first moments (mu = (1 - b1)·g
    # after one step): each leaf to 1e-4 of its largest entry, as the CPU
    # tests hold the port's gradients to JAX's.  The weights then differ by
    # what Adam's first step, lr·m̂/(sqrt(v̂) + eps), makes of the two
    # gradients (near g = 0 it magnifies their last digits): each weight is
    # held to that propagated difference + 1e-6 + 1e-5·|p|.
    c = opt_cfg
    grad_err, p_err, worst = 0.0, 0.0, 0.0
    for pg, pc, mg, mc, vg, vc in zip(
            tree_leaves(gs["params"]), tree_leaves(cs["params"]),
            tree_leaves(gs["opt"]["mu"]), tree_leaves(cs["opt"]["mu"]),
            tree_leaves(gs["opt"]["nu"]), tree_leaves(cs["opt"]["nu"])):
        pg, mg, vg = pg.cpu(), mg.cpu(), vg.cpu()
        e = float((mg - mc).abs().max()) / max(float(mc.abs().max()), 1e-30)
        grad_err = max(grad_err, e)
        step_g = (mg / (1 - c.b1)) / ((vg / (1 - c.b2)).sqrt() + c.eps)
        step_c = (mc / (1 - c.b1)) / ((vc / (1 - c.b2)).sqrt() + c.eps)
        allowed = co["lr"] * (step_g - step_c).abs() + 1e-6 + 1e-5 * pc.abs()
        diff = (pg - pc).abs()
        p_err = max(p_err, float(diff.max()))
        worst = max(worst, float((diff / allowed).max()))
    print(f"  gradients (first moments): max error {grad_err:.2e} of each leaf's largest entry "
          f"(tol 1e-4); updated parameters: max_abs_err {p_err:.3e}, at most {worst:.3f} of the "
          f"propagated tolerance; scan launches {glaunch['rglru_scan']} forward, "
          f"{glaunch['rglru_scan_bwd']} backward for {rg} RG-LRU layers")
    check(grad_err <= 1e-4, "train step gradients differ")
    check(worst <= 1.0, "updated parameters differ")


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


def dnn_phase(dev, seed=0):
    """The DNN path (paper Tables 6-7) at ImageNet-1k's row count, driven
    through dnn/convergence.py: TFIP (queue 10,000) against LIRS, every
    batch gathered on the card by batch_gather (K1); then LIRS's first
    epoch replayed with batch_gather_dma (K2) from the same weights.
    Returns the launches of K1 on the main run and of K2 on the replay."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.shuffler import LIRSShuffler, TFIPShuffler
    from repro_torch.data.device_table import DeviceTable
    from repro_torch.dnn import convergence as C
    from repro_torch.dnn.mlp import MLPClassifier, make_clustered_data
    from repro_torch.kernels import ops

    hidden = C.MODELS[DNN_MODEL]
    print(f"DNN path: {IMAGENET_ROWS} rows requested, DIM {C.DIM}, {C.CLASSES} classes, "
          f"{DNN_MODEL} {hidden}, batch {C.BATCH}, TFIP queue {DNN_QUEUE} vs LIRS, "
          f"{DNN_EPOCHS} epochs each, seed {seed}, gather=block")
    order_s = []
    epoch_order = TFIPShuffler.epoch_order

    def timed_order(self, epoch):  # the host time of TFIP's window shuffle
        t = time.perf_counter()
        out = epoch_order(self, epoch)
        order_s.append(time.perf_counter() - t)
        return out

    runs = []
    TFIPShuffler.epoch_order = timed_order
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = C.compute(n=IMAGENET_ROWS, queue=DNN_QUEUE, epochs=DNN_EPOCHS,
                        models={DNN_MODEL: hidden}, seeds=(seed,), gather="block",
                        device=dev, runs=runs)[DNN_MODEL]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        TFIPShuffler.epoch_order = epoch_order
    n = runs[0][3].rows // DNN_EPOCHS
    steps = sum(len(e) for *_, r in runs for e in r.losses)
    print(f"  phase wall {wall:.2f} s incl. set-up; TFIP's epoch_order on the host "
          f"{sum(order_s):.2f} s ({', '.join(f'{x:.2f}' for x in order_s)}); launches {launches}")
    for _, _, kind, r in runs:
        print(f"  {kind}: {r.rows} rows in {sum(map(len, r.losses))} steps, {r.seconds:.2f} s, "
              f"{sum(map(len, r.losses)) / r.seconds:.1f} steps/s; validation loss by epoch "
              f"{r.val_loss}")
    print(f"  result: {json.dumps(res)}")

    xs, ys, centers = make_clustered_data(IMAGENET_ROWS, C.DIM, C.CLASSES, seed=42,
                                          class_sorted=True, spread=1.0)
    xval, yval, _ = make_clustered_data(2000, C.DIM, C.CLASSES, seed=7, class_sorted=False,
                                        centers=centers)
    check(len(xs) == n == 20 * (IMAGENET_ROWS // 20), f"table of {len(xs)} rows, runs of {n} per epoch")
    # TFIP's class-skewed batches can leave its validation loss above where
    # it started, or drive it past f32's range (the reference does the same
    # on the same data: the class read last dominates); LIRS's must fall,
    # and reach TFIP's minimum, where that is finite, within the epochs
    # (Table 6's direction)
    for _, _, kind, r in runs:
        check(r.rows == DNN_EPOCHS * n, f"{kind} consumed {r.rows} rows, want {DNN_EPOCHS * n}")
        start = MLPClassifier(C.DIM, C.CLASSES, hidden, device=dev, params=r.init).loss(xval, yval)
        print(f"  {kind}: validation loss {start:.4f} before training, {r.val_loss} after each "
              f"epoch; step losses finite in {sum(np.isfinite(e).sum() for e in r.losses)} of "
              f"{sum(map(len, r.losses))} steps")
        if kind == "lirs":
            check(all(np.isfinite(r.val_loss)) and r.val_loss[-1] < start,
                  f"LIRS's validation loss {r.val_loss} did not fall from {start:.4f}")
    if np.isfinite(res["val_traj_tfip"][-1]):  # np.minimum.accumulate keeps a NaN, as in JAX
        check(res["epochs_lirs_mean"] <= DNN_EPOCHS,
              f"LIRS did not reach TFIP's minimum validation loss in {DNN_EPOCHS} epochs")
    check(launches["batch_gather"] == 2 * steps,
          f"batch_gather launched {launches['batch_gather']} times for {steps} steps")
    check(launches["batch_gather_dma"] == 0, "batch_gather_dma launched on the block run")
    check(res["acc_lirs"] > res["acc_tfip"],
          f"LIRS test accuracy {res['acc_lirs']} not above TFIP's {res['acc_tfip']}")

    # LIRS's first epoch again with batch_gather_dma, from the same weights
    lirs = runs[1][3]
    dma = DeviceTable(xs, ys, dev, gather="dma")
    ops.reset_launch_counts()
    replay = C.train(dma, hidden, LIRSShuffler(n, C.BATCH, seed=seed), 1, seed,
                     init=lambda dims, s: lirs.init)
    torch.cuda.synchronize()
    dma_launches = ops.LAUNCHES["batch_gather_dma"]
    check(ops.LAUNCHES["batch_gather"] == 0, "batch_gather launched on the dma replay")
    check(dma_launches == 2 * len(replay.losses[0]),
          f"batch_gather_dma launched {dma_launches} times for {len(replay.losses[0])} steps")
    # the same bytes in, the same kernels and sums after: identical losses
    diff = max(abs(a - b) for a, b in zip(replay.losses[0], lirs.losses[0]))
    check(replay.losses[0] == lirs.losses[0],
          f"dma replay's step losses differ from the block run's (max {diff:.3e})")
    print(f"  dma replay of LIRS epoch 0: {len(replay.losses[0])} steps, {replay.seconds:.2f} s, "
          f"step losses identical to the block run's; launches {dma_launches}")

    # one epoch of each shuffler's batches, gathered by both kernels,
    # against xs[idx] taken on the host
    block = DeviceTable(xs, ys, dev, gather="block")
    for sh in (LIRSShuffler(n, C.BATCH, seed=seed),
               TFIPShuffler(n, C.BATCH, queue_size=DNN_QUEUE, seed=seed)):
        batches = list(sh.epoch_batches(0))
        check(len(batches) == -(-n // C.BATCH) and len(batches[-1]) == (n % C.BATCH or C.BATCH),
              f"{len(batches)} batches in an epoch of {n} rows")
        order = np.concatenate(batches)
        want = (torch.from_numpy(xs[order]).to(dev), torch.from_numpy(ys[order]).to(dev))
        for table in (block, dma):
            got = [table.batch(idx) for idx in batches]
            check(torch.equal(torch.cat([x for x, _ in got]), want[0])
                  and torch.equal(torch.cat([y for _, y in got]), want[1]),
                  f"{type(sh).__name__} batches by {table.gather} differ from xs[idx]")
    print(f"  one epoch of LIRS and of TFIP batches ({len(batches)}, the last of "
          f"{len(batches[-1])} rows), gathered by both kernels, equal xs[idx], ys[idx] taken "
          "on the host")

    # device busy share over a steady window of LIRS steps
    model = MLPClassifier(C.DIM, C.CLASSES, hidden, device=dev, params=lirs.init)
    batches = LIRSShuffler(n, C.BATCH, seed=seed + 1).epoch_batches(0)
    for _ in range(20):
        model.train_batch(*block.batch(next(batches)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DNN_PROFILE_STEPS):
            model.train_batch(*block.batch(next(batches)))
        torch.cuda.synchronize()
        win = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    check(bool(events), "the profiler recorded no device activity")
    busy_us = sum(e.self_device_time_total for e in events)
    calls = sum(e.count for e in events)
    print(f"  profile of {DNN_PROFILE_STEPS} LIRS steps: wall {1e3 * win / DNN_PROFILE_STEPS:.3f} "
          f"ms/step, device busy {1e-3 * busy_us / DNN_PROFILE_STEPS:.3f} ms/step, "
          f"{calls / DNN_PROFILE_STEPS:.1f} device ops/step, busy share {1e-6 * busy_us / win:.3f}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in top[:8] + [e for e in top[8:] if "gather" in e.key]:
        print(f"    {e.self_device_time_total / DNN_PROFILE_STEPS:8.2f} us/step "
              f"{e.count / DNN_PROFILE_STEPS:5.1f} calls/step  {e.key[:90]}")
    return {"batch_gather": launches["batch_gather"], "batch_gather_dma": dma_launches}


def train_phase(dev):
    """The LM training path at recurrentgemma-2b's full width and depth,
    through the launcher; returns the main run's launches."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    torch.cuda.reset_peak_memory_stats(dev)
    print("training recurrentgemma-2b at full width:", " ".join(TRAIN_ARGS))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cfg = get_config("recurrentgemma-2b")
    rg = sum(p.count("rglru") * r for p, r in cfg.stages)  # 18
    steps = summary["steps"]
    secs = summary["step_seconds"]
    print(f"  run incl. init and data {wall:.1f} s; {cfg.num_layers} layers; launches {launches}")
    print(f"  losses {summary['losses']}")
    print(f"  step seconds {[round(x, 4) for x in secs]}; median of steps 2-{steps} "
          f"{statistics.median(secs[1:]):.4f} s ({4096 / statistics.median(secs[1:]):.0f} tokens/s)")
    print(f"  Eq. 1: t_load {summary['t_load']:.4f} s, t_comp {summary['t_comp']:.4f} s, t_overlap "
          f"{summary['t_overlap']:.4f} s, t_unhidden_load {summary['t_unhidden_load']:.4f} s, "
          f"effective {summary['effective_time']:.4f} s; peak memory "
          f"{summary['peak_memory_gib']:.2f} GiB")
    check(steps == 8, f"{steps} steps, want 8")
    check(len(summary["losses"]) == 8 and all(np.isfinite(summary["losses"])),
          f"losses {summary['losses']}")
    check(launches["rglru_scan"] == steps * 2 * rg,
          f"rglru_scan launched {launches['rglru_scan']} times, want {steps * 2 * rg}")
    check(launches["rglru_scan_bwd"] == steps * rg,
          f"rglru_scan_bwd launched {launches['rglru_scan_bwd']} times, want {steps * rg}")
    return launches


def train_profile_phase(dev, steps=2):
    """Where a full-width training step's time goes: after one warm step,
    ``steps`` steps under torch.profiler (device time by kernel, busy
    share).  Runs after the main path, so its launches are not counted
    there."""
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("recurrentgemma-2b")
    opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=10))
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(1), opt, dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    step = make_train_step(cfg, opt)
    g = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, 4097), generator=g, device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state, out = step(state, batch)
    float(out["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, out = step(state, batch)
            float(out["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    check(bool(events), "the profiler recorded no device activity")
    busy_us = sum(e.self_device_time_total for e in events)
    calls = sum(e.count for e in events)
    print(f"profile of {steps} training steps (full width, {n_params:,} parameters, seq 4096): wall "
          f"{1e3 * wall / steps:.1f} ms/step, device busy {1e-3 * busy_us / steps:.1f} ms/step, "
          f"{calls / steps:.0f} device ops/step, busy share {1e-6 * busy_us / wall:.3f}")
    classes = {"GEMM": ("nvjet", "gemm", "cutlass", "xmma"), "rglru_scan": ("rglru_scan",),
               "softmax/reduce": ("softmax", "reduce")}
    split = dict.fromkeys(classes, 0.0)
    split["other elementwise and copies"] = 0.0
    for e in events:
        name = next((c for c, keys in classes.items() if any(k in e.key.lower() for k in keys)),
                    "other elementwise and copies")
        split[name] += e.self_device_time_total
    print("  device ms/step by class: " + ", ".join(
        f"{c} {v / steps / 1e3:.1f} ({v / busy_us:.3f})" for c, v in split.items()))
    top = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in top[:12] + [e for e in top[12:] if "rglru" in e.key]:
        print(f"  {e.self_device_time_total / steps / 1e3:9.3f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:100]}")
    del state
    gc.collect()
    torch.cuda.empty_cache()


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
    gathers = gather_kernel_phase(dev)
    scans = rglru_kernel_phase(dev)
    model_phase(dev)
    train_step_phase(dev)
    linear_svm_phase(dev)
    launches = serve_phase()
    profile_phase(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    rows.append(svm_phase(dev))
    t0 = time.perf_counter()
    for name, count in dnn_phase(dev).items():
        rows.append(dict(gathers[name], launches=count))
    print(f"DNN phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launches = train_phase(dev)
    print(f"training phase {time.perf_counter() - t0:.1f} s")
    train_profile_phase(dev)
    for name in ("rglru_scan", "rglru_scan_bwd"):
        rows.append(dict(scans[name], launches=train_launches[name]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
