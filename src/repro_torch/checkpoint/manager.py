"""Atomic, async, keep-N checkpointing of nested dicts of tensors
(counterpart of src/repro/checkpoint/manager.py).

Layout, as the reference's:  <dir>/step_<N>/{arrays.npz, META.json}
(+ <dir>/step_<N>.tmp.* while writing).  The atomic ``os.replace`` of
the temp directory is what makes a mid-write failure safe: a checkpoint
either fully exists or does not exist at all.

A leaf is a tensor (any device, any dtype) or a Python scalar.  numpy
has no bfloat16, so a bf16 tensor is stored as float32,
which holds every bf16 value exactly, and cast back to the template's
dtype on restore (the reference's ``cast_one``, manager.py:138-142).

``save_async`` copies every leaf to host memory before it returns, and
writes in a background thread.  The copy is what makes it safe: on the
CPU ``t.numpy()`` shares memory with ``t``, and the optimizer updates
parameters in place while the writer runs.  ``restore`` builds new
tensors on each template leaf's device that alias nothing it loaded.
The reference's restore-time resharding waits for the mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_SEP = "||"


def _host_copy(leaf: Any) -> np.ndarray:
    """An owned numpy copy of ``leaf``; bf16 as float32."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return out


def _restore_leaf(key: str, arr: np.ndarray, tmpl: Any) -> Any:
    want = tuple(tmpl.shape) if torch.is_tensor(tmpl) else ()
    if tuple(arr.shape) != want:
        raise ValueError(f"{key}: shape {arr.shape} != {want}")
    if torch.is_tensor(tmpl):
        t = torch.tensor(arr).to(dtype=tmpl.dtype, device=tmpl.device)
        return t.requires_grad_(tmpl.requires_grad)
    return type(tmpl)(arr.item())


def _unflatten(template: Any, arrays: dict, prefix: str = "") -> Any:
    if not isinstance(template, dict):
        if prefix not in arrays:
            raise KeyError(f"checkpoint missing {prefix}")
        return _restore_leaf(prefix, arrays[prefix], template)
    return {
        k: _unflatten(v, arrays, f"{prefix}{_SEP}{k}" if prefix else str(k))
        for k, v in template.items()
    }


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._write_error: list[BaseException] = []

    # ---- save --------------------------------------------------------

    def _write(self, step: int, arrays: dict, meta: dict) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(
            prefix=f"step_{step:08d}.tmp.", dir=self.directory
        )
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "META.json"), "w") as f:
                json.dump({"step": step, **meta}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _snapshot(self, tree: Any) -> dict[str, np.ndarray]:
        return {k: _host_copy(v) for k, v in _flatten(tree).items()}

    def save(self, step: int, tree: Any, meta: dict | None = None) -> str:
        return self._write(step, self._snapshot(tree), meta or {})

    def save_async(self, step: int, tree: Any, meta: dict | None = None):
        """Copy to host memory now, write in the background.  Joins any
        prior write first (at most one outstanding write)."""
        self.wait()
        arrays = self._snapshot(tree)  # owned copies, taken synchronously

        def work():
            try:
                self._write(step, arrays, meta or {})
            except BaseException as e:  # surfaced on next wait()
                self._write_error.append(e)

        self._writer = threading.Thread(target=work, daemon=True)
        self._writer.start()

    def wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error:
            raise self._write_error.pop()

    # ---- restore -----------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and ".tmp." not in name:
                if os.path.exists(
                    os.path.join(self.directory, name, "META.json")
                ):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, template: Any) -> Any:
        """The tree saved at ``step``, shaped, typed and placed like
        ``template``: every tensor leaf is a new tensor in the template
        leaf's dtype, on its device, with its ``requires_grad``."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return _unflatten(template, arrays)

    def meta(self, step: int) -> dict:
        path = os.path.join(
            self.directory, f"step_{step:08d}", "META.json"
        )
        with open(path) as f:
            return json.load(f)

    # ---- gc ----------------------------------------------------------

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"),
                ignore_errors=True,
            )
