"""Atomic checkpointing with restart semantics, in the JAX package's
format (``repro.train.checkpoint``), so either package's checkpoints
restore into the port.

Layout:  <dir>/step_<N>/
             arrays.npz      flat {path: ndarray} of the train state
             manifest.json   step, sampler/pipeline state, user extra, and a
                             content digest — written LAST, so a checkpoint
                             without a manifest is garbage and ignored.

Leaves are named by their tree paths (``path_str``: "params/embed",
"opt/mu/stages/0/1/rglru/wx", ...).  numpy has no bfloat16, so a bf16
leaf is stored as its bits in a ``uint16`` array; restoring into a bf16
template reads any 2-byte array (this format's ``uint16``, or the JAX
package's ml_dtypes bfloat16, which loads as 2-byte void) as those bits.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_path, path_str, tree_unflatten


def _to_numpy(t: torch.Tensor, copy: bool = False) -> np.ndarray:
    """The leaf's bytes on the host: a view of a CPU tensor's storage
    unless ``copy`` (a device tensor is copied either way)."""
    t = t.detach().to("cpu", copy=copy)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True)).to(like.dtype)
    return t.to(like.device)


def _flatten(state, copy: bool = False) -> Dict[str, np.ndarray]:
    return {path_str(path): _to_numpy(leaf, copy) for path, leaf in flatten_with_path(state)}


def _digest(flat: Dict[str, np.ndarray]) -> str:
    """Content digest over the flat state: every leaf name + the first
    4 KiB of its bytes (the JAX package's definition, so its manifests
    verify here)."""
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(flat[k]).tobytes()[:4096])
    return digest.hexdigest()


def _unflatten_like(template, flat: Dict[str, np.ndarray]):
    leaves = []
    for path, leaf in flatten_with_path(template):
        key = path_str(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != template {tuple(leaf.shape)}")
        leaves.append(_from_numpy(arr, leaf))
    return tree_unflatten(template, leaves)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # -------------------------------------------------------------- save
    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None):
        with self._lock:
            self._write(step, _flatten(state), extra or {})

    def save_async(self, step: int, state, extra: Optional[Dict[str, Any]] = None):
        """Snapshot the state to host memory on the caller's thread (so the
        caller may update it in place right after), write it on another;
        a previous pending write is joined first.  The port's train step
        updates the state in place, so CPU leaves are copied too."""
        flat = _flatten(state, copy=True)
        t = threading.Thread(target=self._write, args=(step, flat, extra or {}), daemon=True)
        with self._lock:
            if self._pending is not None:
                self._pending.join()
            self._pending = t
        t.start()

    def wait(self):
        with self._lock:
            if self._pending is not None:
                self._pending.join()
                self._pending = None

    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict[str, Any]):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}_{time.time_ns()}"
        tmp.mkdir(parents=True)
        try:
            np.savez(tmp / "arrays.npz", **flat)
            manifest = {
                "step": step,
                "extra": extra,
                "num_leaves": len(flat),
                "digest": _digest(flat),
                "time": time.time(),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self):
        done = sorted(self._valid_checkpoints())
        for step in done[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{step:010d}", ignore_errors=True)

    # ----------------------------------------------------------- restore
    def _valid_checkpoints(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists() and (p / "arrays.npz").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self._valid_checkpoints()
        return max(steps) if steps else None

    def _load_verified(self, step: int) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Load + integrity-check one step: leaf count AND the manifest's
        content digest must match what is on disk."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        if len(flat) != manifest["num_leaves"]:
            raise ValueError(f"checkpoint {d} corrupt: leaf count mismatch")
        want = manifest.get("digest")
        if want is not None and _digest(flat) != want:
            raise ValueError(f"checkpoint {d} corrupt: content digest mismatch")
        return flat, manifest

    def restore(self, template, step: Optional[int] = None) -> Tuple[Any, Dict, int]:
        """Restore the newest verifiable checkpoint (or exactly ``step``)
        as a new tree shaped, typed and placed as ``template``.

        With ``step=None`` a torn or digest-mismatched checkpoint is
        skipped in favour of the previous valid step; an explicitly
        requested ``step`` raises instead."""
        if step is not None:
            if not (self.dir / f"step_{step:010d}" / "manifest.json").exists():
                raise FileNotFoundError(f"no checkpoint for step {step} in {self.dir}")
            flat, manifest = self._load_verified(step)
            return _unflatten_like(template, flat), manifest["extra"], step
        skipped = []
        for cand in sorted(self._valid_checkpoints(), reverse=True):
            try:
                flat, manifest = self._load_verified(cand)
            except (ValueError, OSError, KeyError, json.JSONDecodeError) as e:
                skipped.append((cand, str(e)))
                continue
            return _unflatten_like(template, flat), manifest["extra"], cand
        if skipped:
            raise FileNotFoundError(
                f"no valid checkpoint in {self.dir}; skipped corrupt steps "
                f"{[s for s, _ in skipped]}"
            )
        raise FileNotFoundError(f"no checkpoint in {self.dir}")
