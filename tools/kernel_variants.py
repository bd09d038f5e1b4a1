#!/usr/bin/env python3
"""Time variants of a kernel source against the source as it stands, on one card.

    python3 tools/kernel_variants.py csr|gather [--after VARIANT]

A variant is one CUDA source of ``src/repro_torch/kernels/csrc`` with a
few text substitutions (``VARIANTS`` below: a constant, a cache policy,
a line of the launch geometry). Every source is compiled once as it
stands, each variant's source once more, and each variant is linked with
the unchanged objects into its own library, in a temporary directory
under ``build/`` (``build.compile_objects`` and ``build.link``, every
``nvcc`` started together). Each variant then runs in a fresh process
(so no variant inherits the L2 that another one left), in turns: every
variant in order, then in reverse. A process checks the variant bit for
bit against the plain version where it keeps the result, through the
port's own wrappers (``kernels.ops``), and times it with
``chip_smoke.time_ms`` (CUDA graphs, CUDA events). With ``--after``, it
then runs that variant on the same inputs and times its own again.

- ``csr``: ``csr_dot`` at the SVM call's shape, a (10000, 5456) padded
  CSR block (2,000-5,456 nonzeros a row, uniform ids) and w of
  16,609,143 f32 (``kernel_ab.svm_csr_block``);
- ``gather``: ``batch_gather`` on the DNN path's pair of tables (B = 100,
  host ids and device ids; B = 1, host ids) and the 2 GiB bandwidth
  shape (B = 8,192, r = 1 and 8, device ids), every id set checked.

Prints the card and, a case, each variant's median (ms per call).
"""
from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

_W_LAST = ("return __ldg(p);", 'uint64_t q; asm("createpolicy.fractional.L2::evict_last.b64 '
           '%0, {};" : "=l"(q)); return load_hinted(p, q);')

# group -> (source, [(variant, [(old text, new text)], result kept)])
VARIANTS = {
    "csr": ("csr_dot.cu", [
        ("as built", [], True),
        ("normal L2 policy", [("L2::evict_first.b64", "L2::evict_normal.b64")], True),
        ("w evict-last", [(_W_LAST[0], _W_LAST[1].format("1.0"))], True),
        ("w evict-last on half", [(_W_LAST[0], _W_LAST[1].format("0.5"))], True),
        ("4 gathers a lane", [("kUnroll = 12;", "kUnroll = 4;")], True),
        ("8 gathers a lane", [("kUnroll = 12;", "kUnroll = 8;")], True),
        ("16 gathers a lane", [("kUnroll = 12;", "kUnroll = 16;")], True),
        ("4 rows a block", [("kRowsPerBlock = 8;", "kRowsPerBlock = 4;")], True),
        ("16 rows a block", [("kRowsPerBlock = 8;", "kRowsPerBlock = 16;")], True),
        ("stream only, no gathers", [("g[u] = gather_w(w + i[u]);",
                                      "g[u] = __int_as_float(i[u]);")], False),
    ]),
    "gather": ("batch_gather.cu", [
        ("as built", [], True),
        ("no spread over the SMs", [("kItemsPerCta / words, spread}", "kItemsPerCta / words}")],
         True),
        ("8 words in flight", [("kGatherUnroll = 4;", "kGatherUnroll = 8;")], True),
    ]),
}


def build_variants(src, variants, out_root):
    """Variant n's library in ``out_root/v<n>/``: the unchanged sources
    once and each variant's source once, all nvcc processes started
    together, then one link each."""
    from repro_torch.kernels import build

    base = os.path.join(out_root, "base")
    os.makedirs(base)
    jobs = {os.path.join(base, s.replace(".cu", ".o")): build.CSRC / s for s in build.SOURCES}
    text = (build.CSRC / src).read_text()
    objs = {}
    for n, (name, subs, _) in enumerate(variants):
        vdir = os.path.join(out_root, f"v{n}")
        os.makedirs(vdir)
        body = text
        for old, new in subs:
            if body.count(old) != 1:
                raise SystemExit(f"variant {name!r}: {old!r} occurs {body.count(old)} times")
            body = body.replace(old, new)
        vsrc = os.path.join(vdir, src)
        with open(vsrc, "w") as f:
            f.write(body)
        jobs[os.path.join(vdir, src.replace(".cu", ".o"))] = vsrc
        objs[name] = [os.path.join(vdir if s == src else base, s.replace(".cu", ".o"))
                      for s in build.SOURCES]
    build.compile_objects(jobs)
    for o in objs.values():
        build.link(o, os.path.join(os.path.dirname(o[build.SOURCES.index(src)]), build.LIB_NAME))


def csr_cases(chip_smoke, dev, g):
    from kernel_ab import svm_csr_block
    from repro_torch.kernels import ops, ref

    idx, val, w = svm_csr_block(chip_smoke, dev, g)
    return {"svm (10000, 5456)": (lambda _: ops.csr_dot(idx, val, w), [None],
                                  [[ref.csr_dot(idx, val, w)]], 20)}


def gather_cases(chip_smoke, dev, g):
    import torch

    from kernel_ab import gather_tables
    from repro_torch.kernels import ops, ref

    x, y, big = gather_tables(chip_smoke, dev, g)
    cases = {}
    for label, tables, b, r, host, calls in (
            ("dnn pair host ids", (x, y), 100, 1, True, 50),
            ("dnn pair device ids", (x, y), 100, 1, False, 50),
            ("b1 pair host ids", (x, y), 1, 1, True, 50),
            ("bw r=1", (big,), 8192, 1, False, 50), ("bw r=8", (big,), 8192, 8, False, 20)):
        nb = tables[0].shape[0] // r
        ids = [torch.randint(0, nb, (b,), generator=g, device=dev, dtype=torch.int32)
               for _ in range(calls)]
        want = [[ref.batch_gather(t, i, r) for t in tables] for i in ids]

        def call(i, tables=tables, r=r):
            return ops.batch_gather_tables(tables, i, block_d=1, rows_per_block=r)
        cases[label] = (call, [i.cpu() for i in ids] if host else ids, want, calls)
    return cases


CASES = {"csr": csr_cases, "gather": gather_cases}


def turn(group, root, n, after=None) -> dict:
    """Variant n's times on every case of the group, in this process (a
    child): checked first where the variant keeps the result; with
    ``after``, timed again after variant ``after`` ran each case."""
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    variants = VARIANTS[group][1]
    name, _, exact = variants[n]
    libs = {k: build.bind(os.path.join(root, f"v{k}", build.LIB_NAME))
            for k in {n, after} - {None}}

    def use(k):  # ops._launch looks build.library up at every launch
        build.library = lambda: libs[k]

    use(n)
    dev = torch.device("cuda")
    cases = CASES[group](chip_smoke, dev, torch.Generator(device=dev).manual_seed(0))
    out = {}
    for label, (call, ids, want, calls) in cases.items():
        for i, w in zip(ids, want) if exact else ():
            got = call(i)
            got = got if isinstance(got, list) else [got]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, w)):
                raise SystemExit(f"{label}: variant {name!r} differs from the plain version")
        it = itertools.cycle(ids)
        t, _ = chip_smoke.time_ms({name: lambda: call(next(it))}, n=calls)
        out[label] = t[name]
        if after is not None:
            use(after)
            for i in ids * 3:
                call(i)
            use(n)
            t, _ = chip_smoke.time_ms({name: lambda: call(next(it))}, n=calls)
            out[f"{label} after {variants[after][0]!r}"] = t[name]
    return out


def main(argv) -> int:
    if len(argv) >= 5 and argv[1] == "--turn":
        after = int(argv[5]) if len(argv) > 5 else None
        print("TURN " + json.dumps(turn(argv[2], argv[3], int(argv[4]), after)), flush=True)
        return 0
    names = {g: [v[0] for v in vs] for g, (_, vs) in VARIANTS.items()}
    if len(argv) not in (2, 4) or argv[1] not in VARIANTS or (
            len(argv) == 4 and (argv[2] != "--after" or argv[3] not in names[argv[1]])):
        print(__doc__, file=sys.stderr)
        return 2
    group = argv[1]
    after = [str(names[group].index(argv[3]))] if len(argv) == 4 else []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    src, variants = VARIANTS[group]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    runs = {name: [] for name in names[group]}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        build_variants(src, variants, tmp)
        order = list(range(len(variants)))
        for n in order + order[::-1]:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", group,
                                   tmp, str(n), *after], capture_output=True, text=True,
                                  timeout=600)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
            if proc.returncode != 0 or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            runs[variants[n][0]].append(json.loads(lines[0][5:]))
    for label in runs[variants[0][0]][0]:
        print(f"{label} ({smi}): " + "; ".join(
            f"{name} {statistics.median(r[label] for r in rs):.6f}" for name, rs in runs.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
