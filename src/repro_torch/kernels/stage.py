"""The dispatch engine's staging copy: the wrapper of ``csrc/stage.cu``.

An unaligned engine call copies each dynamic operand into the leading
corner of its engine-owned, bucket-shaped buffer before the launch (the
reference's ``_stage_into``, src/repro/core/engine.py, one jitted
in-place update per operand).  On the card a :class:`StagePlan` copies
every operand of the call in ONE launch of ``stage_copy_kernel``: one
ctypes call where a ``copy_`` per operand costs a dispatch and a launch
each (ROADMAP C4).  A plan is built once per (buffer set, source shapes)
and keeps its launch table, so a repeat call only writes the source
pointers.  On the CPU the plan runs :func:`stage_copy_plain`, one ``copy_``
per operand into a cached view.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

__all__ = ["StagePlan", "stage_copy", "stage_copy_plain", "stage_geometry",
           "LAUNCHES", "MAX_OPS"]

# Launches of the staging kernel, counted where it is launched.
LAUNCHES = {"stage_copy": 0}

MAX_OPS = 4  # operands one launch stages (csrc/stage.cu kStageMaxOps)


class _StageOp(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
        ("planes", ctypes.c_longlong), ("plane_bytes", ctypes.c_longlong),
        ("dst_pitch", ctypes.c_longlong),
    ]


class _StageTable(ctypes.Structure):
    _fields_ = [("op", _StageOp * MAX_OPS), ("n", ctypes.c_int)]


def stage_geometry(dst: torch.Tensor, shape) -> tuple[int, int, int]:
    """``(planes, plane_bytes, dst_pitch)`` of copying a contiguous source
    of ``shape`` into the leading corner of the contiguous ``dst``: the
    dims inside the last one that differs are whole, so each plane is
    contiguous on both sides.  Raises ValueError unless ``shape`` fits
    ``dst`` and differs from it in at most one dim (the dynamic one)."""
    if not dst.is_contiguous() or len(shape) != dst.dim():
        raise ValueError(
            f"stage_copy: a {tuple(shape)} source into a "
            f"{'' if dst.is_contiguous() else 'non-contiguous '}"
            f"{tuple(dst.shape)} buffer")
    differ = [i for i, (n, m) in enumerate(zip(shape, dst.shape)) if n != m]
    if len(differ) > 1 or any(shape[i] > dst.shape[i] for i in differ):
        raise ValueError(
            f"stage_copy: a {tuple(shape)} source must fit a "
            f"{tuple(dst.shape)} buffer and differ in at most one dim")
    j = differ[0] if differ else 0
    inner = dst.element_size()
    for n in shape[j + 1:]:
        inner *= n
    planes = 1
    for n in shape[:j]:
        planes *= n
    return planes, shape[j] * inner, dst.shape[j] * inner


def _corner(dst: torch.Tensor, shape) -> torch.Tensor:
    return dst[tuple(slice(0, n) for n in shape)]


def stage_copy_plain(dsts: Sequence[torch.Tensor],
                     srcs: Sequence[torch.Tensor]) -> None:
    """The kernel's function in plain PyTorch: one ``copy_`` per operand
    into the leading corner of its buffer."""
    for dst, src in zip(dsts, srcs):
        _corner(dst, src.shape).copy_(src)


class StagePlan:
    """The staging copy of sources of fixed ``shapes`` into fixed ``dsts``.

    On the card, :meth:`run` writes the sources' pointers into a prebuilt
    launch table and makes one launch on ``stream`` (the caller's current
    stream's handle; None queries it); a source that is not contiguous is
    copied contiguous first.  On the CPU it runs the plain version into
    views built once.
    """

    __slots__ = ("dsts", "_views", "_table", "_ops", "_ref")

    def __init__(self, dsts: Sequence[torch.Tensor], shapes):
        if not 1 <= len(dsts) <= MAX_OPS:
            raise ValueError(f"stage_copy: {len(dsts)} operands; a launch "
                             f"stages 1 to {MAX_OPS}")
        self.dsts = list(dsts)
        self._views = self._table = None
        if self.dsts[0].device.type == "cpu":
            self._views = [_corner(d, s) for d, s in zip(self.dsts, shapes)]
            return
        table = _StageTable()
        table.n = len(self.dsts)
        for i, (dst, shape) in enumerate(zip(self.dsts, shapes)):
            planes, plane_bytes, pitch = stage_geometry(dst, shape)
            table.op[i].dst = dst.data_ptr()
            table.op[i].planes = planes
            table.op[i].plane_bytes = plane_bytes
            table.op[i].dst_pitch = pitch
        self._table = table
        # Views of the table's entries and one pointer to it, built once:
        # a call writes the sources through them.
        self._ops = [table.op[i] for i in range(table.n)]
        self._ref = ctypes.byref(table)

    def run(self, srcs: Sequence[torch.Tensor], stream=None) -> None:
        if self._views is not None:
            for view, src in zip(self._views, srcs):
                view.copy_(src)
            return
        from repro_torch.kernels.build import library

        # Contiguous copies live until the launch is enqueued: after that
        # the stream orders any reuse of their memory behind it.
        srcs = [s if s.is_contiguous() else s.contiguous() for s in srcs]
        for op, src in zip(self._ops, srcs):
            op.src = src.data_ptr()
        if stream is None:
            stream = torch.cuda.current_stream(self.dsts[0].device).cuda_stream
        rc = library().vortex_stage_launch(self._ref, stream)
        if rc:
            raise RuntimeError(
                f"stage_copy: kernel launch failed (cudaError {rc})")
        LAUNCHES["stage_copy"] += 1


def stage_copy(dsts: Sequence[torch.Tensor],
               srcs: Sequence[torch.Tensor]) -> None:
    """Copy each source into the leading corner of its buffer: one launch
    on the card, :func:`stage_copy_plain` for tensors on the CPU.  Sources
    and buffers share a dtype and a device."""
    for dst, src in zip(dsts, srcs):
        if dst.dtype != src.dtype or dst.device != src.device:
            raise TypeError(
                f"stage_copy: a {src.dtype} source on {src.device} into a "
                f"{dst.dtype} buffer on {dst.device}")
    if dsts[0].device.type != "cpu" and dsts[0].device.type != "cuda":
        raise ValueError("stage_copy: tensors on the CPU or one CUDA device")
    StagePlan(dsts, [s.shape for s in srcs]).run(srcs)
