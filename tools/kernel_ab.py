#!/usr/bin/env python3
"""Time the redesigned kernels of two source trees on one card, in turns.

    python3 tools/kernel_ab.py OLD_ROOT NEW_ROOT [--kernels gather,attention,decode,scan]

Each turn is a fresh process that builds the kernels of one tree
(``<root>/src``, into ``<root>/build/``) and times, with
``chip_smoke.time_ms`` (CUDA graphs, CUDA events), the kernel groups
``--kernels`` names (all four by default):

- ``batch_gather_dma`` at the DNN path's shape (the pair of launches of
  one ``DeviceTable.batch``: B = 100 of a (1281160, 32) f32 table and a
  (1281160, 1) int32 one, rows_per_step 8) and the 2 GiB bandwidth shape
  (B = 8,192 of (1048576, 512) f32, r = 1 and 8), against
  ``index_select``;
- ``flash_attention`` in bf16, causal, q (1,S,32,128), k/v (1,S,8,128) at
  S = 128 (the serving prefill) and 4,096 (granite-3-8b's context),
  against ``scaled_dot_product_attention``;
- ``flash_decode`` at the serving shape (q (8,32,128), caches
  (8,160,8,128) bf16, chip_smoke's eight ``cur`` values), against
  ``scaled_dot_product_attention`` with the position mask;
- ``rglru_scan`` and ``rglru_scan_bwd`` at the training path's shape
  (1, 4096, 2560) f32 (no library call computes a linear recurrence).

The gather group also profiles (``torch.profiler``, device time per
launch over 200 eager launches) ``batch_gather_dma`` on the DNN path's
two tables at rows_per_step 1, 8 and 100, and ``batch_gather`` beside it.

The turns run OLD, NEW, NEW, OLD; each prints one JSON line, and the
script prints every tree's medians at the end. Unpack the older tree with
``git archive`` into a directory ``.gitignore`` lists, copy the checkout
with it to the machine with the card, and run from the repository's root
there (about two minutes for ``--kernels decode,scan``):

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 tools/kernel_ab.py build/parent . --kernels decode,scan
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(root: str, groups) -> dict:
    """One tree's timings, in this process (called in a child)."""
    import torch

    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke  # the timing helper of the newer tree
    from repro_torch.kernels import build, ops

    build.library()
    dev = torch.device("cuda")
    out = {"root": root}
    for name in groups:
        g = torch.Generator(device=dev).manual_seed(0)
        GROUPS[name](chip_smoke, ops, dev, g, out)
        torch.cuda.empty_cache()
    return out


def time_gather(chip_smoke, ops, dev, g, out):
    import itertools

    import torch

    n = 20 * (chip_smoke.IMAGENET_ROWS // 20)
    x = torch.randn(n, 32, generator=g, device=dev)
    y = torch.randint(0, 20, (n, 1), generator=g, device=dev, dtype=torch.int32)
    big = torch.randn(*chip_smoke.GATHER_BW[:2], generator=g, device=dev)
    for label, tables, b, r, calls in (("dnn_pair", (x, y), 100, 1, 50),
                                       ("bw_r1", (big,), 8192, 1, 50),
                                       ("bw_r8", (big,), 8192, 8, 20)):
        nb = tables[0].shape[0] // r
        ids = [torch.randint(0, nb, (b,), generator=g, device=dev, dtype=torch.int32)
               for _ in range(calls)]
        want = [t.view(nb, -1).index_select(0, ids[0]).view(-1, t.shape[1]) for t in tables]
        got = [ops.batch_gather_dma(t, ids[0], block_d=t.shape[1], rows_per_block=r)
               for t in tables]
        assert all(torch.equal(a, w) for a, w in zip(got, want)), label

        def timed(f):
            it = itertools.cycle(ids)
            return lambda: f(next(it))

        t, _ = chip_smoke.time_ms({
            "kernel": timed(lambda i: [ops.batch_gather_dma(tb, i, block_d=tb.shape[1],
                                                            rows_per_block=r) for tb in tables]),
            "library": timed(lambda i: [tb.view(nb, -1).index_select(0, i) for tb in tables]),
        }, n=calls)
        out[f"batch_gather_dma {label}"] = t
    del big
    torch.cuda.empty_cache()
    out["per-launch device us"] = profile_gathers(ops, x, y, ids=[
        torch.randint(0, n, (100,), generator=g, device=dev, dtype=torch.int32)
        for _ in range(50)])


def time_attention(chip_smoke, ops, dev, g, out):
    import torch
    import torch.nn.functional as F

    for s in (128, 4096):
        q = torch.randn(1, s, 32, 128, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(1, s, 8, 128, generator=g, device=dev).bfloat16() for _ in range(2))
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        err = float((ops.flash_attention(q, k, v).float() - ref.transpose(1, 2).float()).abs().max())
        t, _ = chip_smoke.time_ms({
            "kernel": lambda: ops.flash_attention(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=True),
        }, n=50 if s == 128 else 10)
        t["max_abs_err_vs_library"] = err
        out[f"flash_attention S={s}"] = t


def time_decode(chip_smoke, ops, dev, g, out):
    import torch
    import torch.nn.functional as F

    c = 160
    q = torch.randn(8, 32, 128, generator=g, device=dev).bfloat16()
    kc, vc = (torch.randn(8, c, 8, 128, generator=g, device=dev).bfloat16() for _ in range(2))
    cur = torch.tensor([0, 17, 31, 32, 100, c - 1, c, c + 11], dtype=torch.int32, device=dev)
    q4 = q[:, :, None]
    kt, vt = (z.transpose(1, 2).contiguous() for z in (kc, vc))
    mask = (torch.arange(c, device=dev)[None, :] <= cur[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True)

    err = float((ops.flash_decode(q, kc, vc, cur).float() - library()[:, :, 0].float()).abs().max())
    t, _ = chip_smoke.time_ms({"kernel": lambda: ops.flash_decode(q, kc, vc, cur),
                               "library": library})
    t["max_abs_err_vs_library"] = err
    out["flash_decode serving"] = t


def time_scan(chip_smoke, ops, dev, g, out):
    import torch

    shape = (1, 4096, 2560)
    a = torch.rand(shape, generator=g, device=dev) * 0.4 + 0.6
    x, dh = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    h = ops.rglru_scan(a, x)
    t, _ = chip_smoke.time_ms({"forward": lambda: ops.rglru_scan(a, x),
                               "backward": lambda: ops.rglru_scan_bwd(a, h, dh)}, n=20)
    out["rglru_scan"] = t


GROUPS = {"gather": time_gather, "attention": time_attention, "decode": time_decode,
          "scan": time_scan}


def profile_gathers(ops, x, y, ids, reps=200):
    """Device time per launch of each gather kernel on the DNN path's
    feature (x) and label (y) tables, B = 100."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = {"batch_gather": lambda t, i: ops.batch_gather(t, i, block_d=t.shape[1])}
    for m in (1, 8, 100):
        calls[f"batch_gather_dma m={m}"] = (
            lambda t, i, m=m: ops.batch_gather_dma(t, i, block_d=t.shape[1], rows_per_step=m))
    out = {}
    for name, fn in calls.items():
        for label, table in (("features", x), ("labels", y)):
            for i in range(20):
                fn(table, ids[i % len(ids)])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(reps):
                    fn(table, ids[i % len(ids)])
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            out[f"{name} {label}"] = sum(e.self_device_time_total for e in events) / reps
    return out


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--turn":
        print("TURN " + json.dumps(turn(argv[2], argv[3].split(","))), flush=True)
        return 0
    groups = ",".join(GROUPS)
    if len(argv) == 5 and argv[3] == "--kernels":
        groups, argv = argv[4], argv[:3]
    if len(argv) != 3 or not set(groups.split(",")) <= set(GROUPS):
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (os.path.abspath(a) for a in argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results = {old: [], new: []}
    for root in (old, new, new, old):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root, groups],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[0][5:])
        print(json.dumps(res), flush=True)
        results[root].append(res)
    for root, runs in results.items():
        print(f"medians of {root} ({smi}):")
        for key in runs[0]:
            if key == "root":
                continue
            cols = {c: statistics.median(r[key][c] for r in runs) for c in runs[0][key]
                    if isinstance(runs[0][key][c], (int, float))}
            print(f"  {key}: " + ", ".join(f"{c} {v:.6f}" for c, v in cols.items()))
    print("(times in ms per call; 'per-launch device us' in microseconds per launch)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
