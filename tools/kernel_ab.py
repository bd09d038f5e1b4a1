#!/usr/bin/env python3
"""Time the redesigned kernels of two source trees on one card, in turns.

    python3 tools/kernel_ab.py OLD_ROOT NEW_ROOT [--kernels gather,attention,decode,scan,csr]

Each turn is a fresh process that builds the kernels of one tree
(``<root>/src``, into ``<root>/build/``) and times, with
``chip_smoke.time_ms`` (CUDA graphs, CUDA events), the kernel groups
``--kernels`` names (all five by default):

- ``batch_gather`` (K1) and ``batch_gather_dma`` (K2) at the DNN path's
  shape (one ``DeviceTable.batch``: B = 100 of a (1281160, 32) f32 table
  and a (1281160, 1) int32 one; K2 at rows_per_step 8), the same pair at
  B = 1, and the 2 GiB bandwidth shape (B = 8,192 of (1048576, 512) f32,
  r = 1 and 8), against ``index_select``.  K1 gathers the pair in one
  launch where the tree has ``ops.batch_gather_tables`` (device ids, and
  host ids in the launch's parameters as ``batch_gather host ids``), else
  one launch a table on device ids;
- ``flash_attention`` in bf16, causal, q (1,S,32,128), k/v (1,S,8,128) at
  S = 128 (the serving prefill) and 4,096 (granite-3-8b's context),
  against ``scaled_dot_product_attention``; and in f32 at S = 128 (the
  CUDA-core kernel);
- ``flash_decode`` at the serving shape (q (8,32,128), caches
  (8,160,8,128) bf16, chip_smoke's eight ``cur`` values), against
  ``scaled_dot_product_attention`` with the position mask; and in f32
  (the tile kernel);
- ``rglru_scan`` and ``rglru_scan_bwd`` at the training path's shape
  (1, 4096, 2560) f32 (no library call computes a linear recurrence);
- ``csr_dot`` at the SVM call's shape: a (10000, 5456) padded CSR block
  (2,000-5,456 nonzeros a row, uniform ids) and w of 16,609,143, against
  ``embedding_bag``.

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


def gather_tables(chip_smoke, dev, g):
    """The gather groups' tables: the DNN path's features (1281160, 32) f32
    and labels (1281160, 1) int32, and the 2 GiB bandwidth table."""
    import torch

    n = 20 * (chip_smoke.IMAGENET_ROWS // 20)
    x = torch.randn(n, 32, generator=g, device=dev)
    y = torch.randint(0, 20, (n, 1), generator=g, device=dev, dtype=torch.int32)
    big = torch.randn(*chip_smoke.GATHER_BW[:2], generator=g, device=dev)
    return x, y, big


def svm_csr_block(chip_smoke, dev, g):
    """``csr_dot``'s inputs at the SVM call's shape: a (10000, 5456) padded
    CSR block, 2,000-5,456 nonzeros a row with uniform ids, and w of
    16,609,143 f32."""
    import torch

    b, k, d = chip_smoke.SVM_TRAIN, chip_smoke.SVM_NNZ[1], chip_smoke.WEBSPAM_DIM
    idx = torch.randint(0, d, (b, k), generator=g, device=dev, dtype=torch.int32)
    val = torch.randn(b, k, generator=g, device=dev)
    keep = torch.randint(chip_smoke.SVM_NNZ[0], k + 1, (b, 1), generator=g, device=dev)
    pad = torch.arange(k, device=dev)[None, :] >= keep  # pad_csr's zero suffix
    idx, val = idx.masked_fill(pad, 0), val.masked_fill(pad, 0.0)
    w = torch.randn(d, generator=g, device=dev)
    return idx, val, w


def time_gather(chip_smoke, ops, dev, g, out):
    import itertools

    import torch

    x, y, big = gather_tables(chip_smoke, dev, g)
    n = x.shape[0]
    fused = hasattr(ops, "batch_gather_tables")  # one K1 launch for several tables
    for label, tables, b, r, calls in (("dnn_pair", (x, y), 100, 1, 50),
                                       ("b1_pair", (x, y), 1, 1, 50),
                                       ("bw_r1", (big,), 8192, 1, 50),
                                       ("bw_r8", (big,), 8192, 8, 20)):
        nb = tables[0].shape[0] // r
        ids = [torch.randint(0, nb, (b,), generator=g, device=dev, dtype=torch.int32)
               for _ in range(calls)]
        host = [i.cpu() for i in ids]
        want = [t.view(nb, -1).index_select(0, ids[0]).view(-1, t.shape[1]) for t in tables]

        def timed(f, ids=ids):
            it = itertools.cycle(ids)
            return lambda: f(next(it))

        def k1(i):
            if fused:
                return ops.batch_gather_tables(tables, i, block_d=1, rows_per_block=r)
            return [ops.batch_gather(t, i, block_d=t.shape[1], rows_per_block=r) for t in tables]

        def k2(i):
            return [ops.batch_gather_dma(t, i, block_d=t.shape[1], rows_per_block=r)
                    for t in tables]

        fns = {"batch_gather": timed(k1), "batch_gather_dma": timed(k2),
               "library": timed(lambda i: [t.view(nb, -1).index_select(0, i) for t in tables])}
        if fused and b <= ops._PARAM_IDS:
            fns["batch_gather host ids"] = timed(k1, host)
        for name in fns:
            if name != "library":
                got = (k1(host[0]) if name.endswith("host ids") else
                       k1(ids[0]) if name == "batch_gather" else k2(ids[0]))
                assert all(torch.equal(a, w) for a, w in zip(got, want)), (label, name)
        t, _ = chip_smoke.time_ms(fns, n=calls)
        out[f"gathers {label}"] = t
    del big
    torch.cuda.empty_cache()
    out["per-launch device us"] = profile_gathers(ops, x, y, ids=[
        torch.randint(0, n, (100,), generator=g, device=dev, dtype=torch.int32)
        for _ in range(50)])


def time_csr(chip_smoke, ops, dev, g, out):
    import torch
    import torch.nn.functional as F

    idx, val, w = svm_csr_block(chip_smoke, dev, g)
    w2 = w[:, None]
    got = ops.csr_dot(idx, val, w)
    lib = F.embedding_bag(idx, w2, per_sample_weights=val, mode="sum")[:, 0]
    t, _ = chip_smoke.time_ms({
        "kernel": lambda: ops.csr_dot(idx, val, w),
        "library": lambda: F.embedding_bag(idx, w2, per_sample_weights=val, mode="sum")[:, 0],
    }, n=20)
    t["max_abs_err_vs_library"] = float((got - lib).abs().max())
    out["csr_dot svm"] = t


def time_attention(chip_smoke, ops, dev, g, out):
    import torch
    import torch.nn.functional as F

    for s, dt in ((128, torch.bfloat16), (4096, torch.bfloat16), (128, torch.float32)):
        q = torch.randn(1, s, 32, 128, generator=g, device=dev).to(dt)
        k, v = (torch.randn(1, s, 8, 128, generator=g, device=dev).to(dt) for _ in range(2))
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        err = float((ops.flash_attention(q, k, v).float() - ref.transpose(1, 2).float()).abs().max())
        t, _ = chip_smoke.time_ms({
            "kernel": lambda: ops.flash_attention(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=True),
        }, n=50 if s == 128 else 10)
        t["max_abs_err_vs_library"] = err
        out[f"flash_attention S={s}" + (" f32" if dt == torch.float32 else "")] = t


def time_decode(chip_smoke, ops, dev, g, out):
    import torch
    import torch.nn.functional as F

    c = 160
    cur = torch.tensor([0, 17, 31, 32, 100, c - 1, c, c + 11], dtype=torch.int32, device=dev)
    mask = (torch.arange(c, device=dev)[None, :] <= cur[:, None])[:, None, None, :]
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(8, 32, 128, generator=g, device=dev).to(dt)
        kc, vc = (torch.randn(8, c, 8, 128, generator=g, device=dev).to(dt) for _ in range(2))
        q4 = q[:, :, None]
        kt, vt = (z.transpose(1, 2).contiguous() for z in (kc, vc))

        def library():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True)

        err = float((ops.flash_decode(q, kc, vc, cur).float()
                     - library()[:, :, 0].float()).abs().max())
        t, _ = chip_smoke.time_ms({"kernel": lambda: ops.flash_decode(q, kc, vc, cur),
                                   "library": library})
        t["max_abs_err_vs_library"] = err
        out["flash_decode serving" + (" f32" if dt == torch.float32 else "")] = t


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
          "scan": time_scan, "csr": time_csr}


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
