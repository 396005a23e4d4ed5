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

Sharded state (DTensor leaves on a mesh) is saved as full tensors: every
rank gathers each leaf (a collective, so every rank calls ``save``) and
rank 0 of the world writes.  ``save`` and ``wait`` return on every rank
only once rank 0 has published the step, and rank 0's write error is
raised on every rank.  ``restore(step, template, shardings)``
loads on the host and places each leaf onto its target mesh and
placements (src/repro/checkpoint/manager.py:130-149): this is how an
elastic re-mesh (runtime/elastic.py) moves a checkpoint onto a smaller
mesh.  A DTensor template leaf with no sharding given is placed like the
template.
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

from repro_torch.placement import Sharding, is_dtensor

__all__ = ["CheckpointManager", "CheckpointWriteError"]

_SEP = "||"


def _dist():
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointWriteError(RuntimeError):
    """Rank 0's checkpoint write failed: raised on every other rank."""


def _settle(err: BaseException | None) -> None:
    """Every rank learns rank 0's write outcome (``err``, or None), which
    also makes every rank wait until rank 0 has published the step; rank
    0 re-raises its error, every other rank raises
    :class:`CheckpointWriteError`.  With one rank: raise ``err`` if any."""
    if _dist()[1] > 1:
        import torch.distributed as dist

        msg = [None if err is None else f"{type(err).__name__}: {err}"]
        dist.broadcast_object_list(msg, src=0)
        if err is None and msg[0] is not None:
            raise CheckpointWriteError(f"rank 0's write failed: {msg[0]}")
    if err is not None:
        raise err


def _host_copy(leaf: Any) -> np.ndarray:
    """An owned numpy copy of ``leaf`` (a DTensor's full value); bf16 as
    float32."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if is_dtensor(t):
            t = t.full_tensor()
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


def _restore_leaf(key: str, arr: np.ndarray, tmpl: Any,
                  sharding: Sharding | None) -> Any:
    want = tuple(tmpl.shape) if torch.is_tensor(tmpl) else ()
    if tuple(arr.shape) != want:
        raise ValueError(f"{key}: shape {arr.shape} != {want}")
    if not torch.is_tensor(tmpl):
        return type(tmpl)(arr.item())
    if sharding is None and is_dtensor(tmpl):
        sharding = Sharding(tmpl.device_mesh, tuple(tmpl.placements))
    dev = (torch.device(sharding.mesh.device_type) if sharding is not None
           else tmpl.device)
    t = torch.tensor(arr).to(dtype=tmpl.dtype, device=dev)
    if sharding is not None:
        from torch.distributed.tensor import distribute_tensor

        t = distribute_tensor(t, sharding.mesh, sharding.placements,
                              src_data_rank=None)
    return t.requires_grad_(tmpl.requires_grad)


def _unflatten(template: Any, arrays: dict, shardings: Any,
               prefix: str = "") -> Any:
    if not isinstance(template, dict):
        if prefix not in arrays:
            raise KeyError(f"checkpoint missing {prefix}")
        return _restore_leaf(prefix, arrays[prefix], template, shardings)
    return {
        k: _unflatten(v, arrays, None if shardings is None else shardings[k],
                      f"{prefix}{_SEP}{k}" if prefix else str(k))
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
        """Write ``tree`` at ``step``; with several ranks every rank calls
        it, rank 0 writes, and all return once the step is published (or
        all raise: :func:`_settle`)."""
        arrays = self._snapshot(tree)
        final = os.path.join(self.directory, f"step_{step:08d}")
        err = None
        if _dist()[0] == 0:
            try:
                final = self._write(step, arrays, meta or {})
            except BaseException as e:
                err = e
        _settle(err)
        return final

    def save_async(self, step: int, tree: Any, meta: dict | None = None):
        """Copy to host memory now, write in the background (rank 0 only,
        with several ranks).  Joins any prior write first (at most one
        outstanding write); with several ranks every rank calls it."""
        self.wait()
        arrays = self._snapshot(tree)  # owned copies, taken synchronously
        if _dist()[0] != 0:
            return

        def work():
            try:
                self._write(step, arrays, meta or {})
            except BaseException as e:  # surfaced on next wait()
                self._write_error.append(e)

        self._writer = threading.Thread(target=work, daemon=True)
        self._writer.start()

    def wait(self):
        """Join the outstanding write.  With several ranks every rank calls
        it (as every rank calls ``save_async``): each returns once rank 0
        has published the step, so ``latest_step`` then agrees on every
        rank, and each raises if rank 0's write failed (:func:`_settle`)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        _settle(self._write_error.pop() if self._write_error else None)

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

    def restore(self, step: int, template: Any,
                shardings: Any | None = None) -> Any:
        """The tree saved at ``step``, shaped and typed like ``template``:
        every tensor leaf is a new tensor in the template leaf's dtype
        with its ``requires_grad``, on its device, or, where
        ``shardings`` (a tree of ``Sharding``s beside ``template``,
        ``models.partitioning.spec_tree_to_shardings``) names one, a
        DTensor on that mesh and placements."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return _unflatten(template, arrays, shardings)

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
