"""Meshes (counterpart of src/repro/launch/mesh.py).

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, with the reference's axis names:
``("data", "model")``, or ``("pod", "data", "model")`` across pods.
:class:`MeshShape` is the same axes and sizes with no processes behind
them (the reference's ``AbstractMesh``): enough for
``models.partitioning.make_rules`` and every spec tree, so the specs of
a 256-chip mesh are computed on one host.

Nothing here runs when the module is imported.  ``make_host_mesh``
starts a process group only when none exists and the mesh is one rank;
a larger mesh needs the caller's ``torch.distributed.init_process_group``
(address, world size and rank: nothing on the machine announces a
cluster).  :func:`destroy` ends the group the module started.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["MeshShape", "MeshSizeError", "make_host_mesh",
           "make_production_mesh", "destroy"]


class MeshSizeError(RuntimeError):
    """The world's size does not match the mesh asked for."""


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names with no devices (``AbstractMesh``)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"{self.shape} vs {self.axis_names}")

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return self.axis_names


def _production_shape(multi_pod: bool) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


_OWNED: list[str] = []  # the FileStore path of a group this module started


def _start_one_rank(device: torch.device) -> None:
    """A 1-rank process group (NCCL on the card, gloo on the CPU) over a
    FileStore in a fresh temporary file: no port to collide on."""
    fd, path = tempfile.mkstemp(prefix="repro_torch_mesh-")
    os.close(fd)
    os.unlink(path)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend, store=dist.FileStore(path, 1),
                            world_size=1, rank=0)
    _OWNED.append(path)


def _init_mesh(device: torch.device, shape: tuple[int, ...],
               names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        if n != 1:
            raise MeshSizeError(
                f"a {shape} mesh needs {n} ranks; start the process group "
                "(torch.distributed.init_process_group) first")
        _start_one_rank(device)
    world = dist.get_world_size()
    if world != n:
        raise MeshSizeError(
            f"a {shape} mesh over {names} needs {n} ranks, the world has "
            f"{world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A ``(data, model)`` DeviceMesh over the world's ranks (tests,
    examples, the server).  With no process group and ``data * model ==
    1`` it starts a 1-rank group itself: NCCL on the card (the default;
    raises without a GPU), gloo with ``device="cpu"``."""
    return _init_mesh(resolve_device(device), (data, model),
                      ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh: 16x16 (256 ranks) or 2x16x16 across pods
    (512).  Raises :class:`MeshSizeError` unless the world has exactly
    that many ranks."""
    ms = _production_shape(multi_pod)
    return _init_mesh(resolve_device(device), ms.shape, ms.axis_names)


def destroy() -> None:
    """End the process group :func:`make_host_mesh` started, if any (a
    group the caller started is the caller's to end)."""
    while _OWNED:
        path = _OWNED.pop()
        if dist.is_initialized():
            dist.destroy_process_group()
        if os.path.exists(path):
            os.unlink(path)
