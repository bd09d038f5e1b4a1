"""Build and load the port's CUDA kernels (nvcc → one shared library).

The sources in ``csrc/`` have a plain C interface and are bound with
``ctypes``; no PyTorch header is compiled, so a cold build takes
seconds.  Each ``.cu`` is compiled to an object by its own ``nvcc``
process, all started together, then one ``nvcc -shared`` links them.
The library lands in ``build/repro_torch/<hash>/`` at the repository
root, keyed by the sources and flags, so an edited source is rebuilt and
an unchanged one is reused.  Building happens at first use, never at
import: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention.cu", "flash_decode.cu", "csr_dot.cu", "batch_gather.cu",
           "rglru_scan.cu")
HEADERS = ("attention_tile.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argtypes of the extern "C" entry points (see the .cu files)
_SIGNATURES = {
    "repro_torch_flash_attention": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "repro_torch_flash_decode": [_P, _P, _P, _P, _P] + [_I] * 6 + [_P],
    "repro_torch_csr_dot": [_P, _P, _P, _P, _I, _I, _P],
    "repro_torch_batch_gather": [_P, _P, _P, _L, _L, _L, _P],
    "repro_torch_batch_gather_dma": [_P, _P, _P, _L, _L, _L, _I, _P],
    "repro_torch_rglru_scan": [_P, _P, _P, _I, _I, _I, _P],
    "repro_torch_rglru_scan_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH"
    )


def build_dir() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source set has no library yet; returns
    the library's path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept in ``build.log`` beside it."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [p.communicate()[0] for p in procs]
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        log = "".join(f"== {s}\n{text}" for s, text in zip(SOURCES, logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", *ARCH_FLAGS, *objs, "-o", tmp_lib, "-lcudart"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "build.log").write_text(log + link.stdout)
        os.replace(tmp_lib, lib)  # atomic: a reader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
