"""Fault-tolerant checkpointing: atomic, async, resumable (port of
`repro.train.ckpt`, with the same on-disk layout).

Layout: <dir>/step_<N>/arrays.npz + manifest.json, plus <dir>/LATEST
(written to a temp file and moved with os.replace, so a crash mid-write
never corrupts an existing checkpoint).  The manifest holds the sha256 of
arrays.npz, checked before a restore trusts the arrays; `restore_latest`
walks past checkpoints that fail the check.

Tensors are copied to the host in `save` (synchronously); serialization
runs on a background thread when `async_save` is set, and `wait()` joins
it before the next save.  numpy has no bfloat16: a bf16 tensor is stored
losslessly as its int16 bit pattern, and the manifest lists those paths
under "bf16" so `restore` views them back.  Restored tensors go to the
device of the matching template leaf.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map, tree_paths


class CheckpointCorruptError(RuntimeError):
    """A checkpoint on disk fails its manifest checksums."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_host(x) -> np.ndarray:
    x = torch.as_tensor(x).detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        self._sweep_stale_tmp()

    def _sweep_stale_tmp(self):
        """Remove the temp files of a save that crashed before its
        os.replace (`.tmp_step_<N>_<pid>` directories, `.LATEST.tmp`): a
        new manager owns the directory, so they are garbage."""
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if name.startswith(".tmp_step_"):
                shutil.rmtree(path, ignore_errors=True)
            elif name == ".LATEST.tmp":
                try:
                    os.remove(path)
                except OSError:
                    pass

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None):
        """state: a tree of tensors.  extra: JSON-serializable metadata
        (the data-pipeline position)."""
        flat = tree_paths(state)
        bf16 = [k for k, v in flat if torch.as_tensor(v).dtype
                == torch.bfloat16]
        host = {k: _to_host(v) for k, v in flat}
        self.wait()

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            manifest = {
                "step": step,
                "time": time.time(),
                "extra": extra or {},
                "n_arrays": len(host),
                "bytes": int(sum(a.nbytes for a in host.values())),
                "bf16": bf16,
                "files": {"arrays.npz":
                          _sha256(os.path.join(tmp, "arrays.npz"))},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            ptr_tmp = os.path.join(self.dir, ".LATEST.tmp")
            with open(ptr_tmp, "w") as f:
                f.write(str(step))
            os.replace(ptr_tmp, os.path.join(self.dir, "LATEST"))
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        """Steps of the completed checkpoints (manifest present)."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if os.path.exists(ptr):
            with open(ptr) as f:
                s = int(f.read().strip())
            if s in self.all_steps():
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> None:
        """Check a checkpoint's files against its manifest checksums;
        raise `CheckpointCorruptError` on a mismatch or a missing file.
        A manifest without checksums verifies trivially."""
        path = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable manifest ({e})") from e
        for name, want in manifest.get("files", {}).items():
            fpath = os.path.join(path, name)
            if not os.path.exists(fpath):
                raise CheckpointCorruptError(
                    f"step {step}: missing file {name}")
            got = _sha256(fpath)
            if got != want:
                raise CheckpointCorruptError(
                    f"step {step}: checksum mismatch on {name} "
                    f"(manifest {want[:12]}…, disk {got[:12]}…)")

    def restore(self, step: int, template, verify: bool = True):
        """Restore into the structure of `template` -> (tree, manifest);
        each tensor goes to its template leaf's device."""
        self.wait()
        if verify:
            self.verify(step)
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        bf16 = set(manifest.get("bf16", ()))
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: torch.from_numpy(data[k]) for k in data.files}
        for k in bf16:
            flat[k] = flat[k].view(torch.bfloat16)
        paths = iter([p for p, _ in tree_paths(template)])
        tree = tree_map(lambda leaf: flat[next(paths)].to(
            torch.as_tensor(leaf).device), template)
        return tree, manifest

    def restore_latest(self, template):
        """Restore the newest intact checkpoint, walking past corrupt ones
        -> (tree, manifest, step), or None if none is intact."""
        self.wait()
        for step in reversed(self.all_steps()):
            try:
                tree, manifest = self.restore(step, template, verify=True)
                return tree, manifest, step
            except CheckpointCorruptError:
                continue
        return None
