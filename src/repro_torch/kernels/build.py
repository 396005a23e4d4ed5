"""Build and load the hand-written CUDA kernels (csrc/*.cu) at first use.

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source started together, then linked into one shared library with a plain
C interface that :mod:`ctypes` loads.  The library lands in
``csrc/_build/`` (listed in ``.gitignore``) under a name keyed by the
content hash of every ``csrc/*.cu`` and ``csrc/*.cuh``, so an edited
source or header rebuilds and a built one is reused.  Nothing here runs
at import time: the CPU-only test environment imports every module and
has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["library", "source_digest", "CUDA_ERROR_NAMES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = (
    "gemm.cu", "attention.cu", "attention_tc.cu", "attention_decode.cu",
    "grouped_gemm.cu", "stage.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# A few cudaError_t values worth naming in a raised message.
CUDA_ERROR_NAMES = {
    1: "cudaErrorInvalidValue",
    2: "cudaErrorMemoryAllocation",
    9: "cudaErrorInvalidConfiguration",
    98: "cudaErrorInvalidDeviceFunction",
    209: "cudaErrorNoKernelImageForDevice",
    700: "cudaErrorIllegalAddress",
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ at first use "
        "and need the CUDA toolkit on PATH"
    )


def source_digest() -> str:
    """The digest that names the library: every kernel source and header
    and the nvcc flags (a calibration fingerprint records it too)."""
    h = hashlib.sha256()
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{Path(s).stem}-{target.stem}.o" for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    (BUILD_DIR / f"{target.stem}.ptxas.log").write_text("\n".join(logs))
    for src, p, log in zip(SOURCES, procs, logs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    tmp = target.with_suffix(".tmp.so")
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS, *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, target)
    for obj in objs:
        obj.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vortex_gemm_launch.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.vortex_gemm_launch.restype = i
    lib.vortex_gemm_tc_launch.argtypes = [
        vp, vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, i, vp,
    ]
    lib.vortex_gemm_tc_launch.restype = i
    lib.vortex_gemm_tma_launch.argtypes = [
        vp, vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, i, i, i, vp,
    ]
    lib.vortex_gemm_tma_launch.restype = i
    lib.flash_attention_launch.argtypes = [
        vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, f, f, i, vp,
    ]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_tc_launch.argtypes = [
        vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, i, i, f, f, vp,
    ]
    lib.flash_attention_tc_launch.restype = i
    lib.flash_decode_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, f, f, i, i, i,
        vp,
    ]
    lib.flash_decode_launch.restype = i
    lib.vortex_grouped_gemm_launch.argtypes = [
        vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, vp,
    ]
    lib.vortex_grouped_gemm_launch.restype = i
    lib.vortex_grouped_gemm_tc_launch.argtypes = [
        vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, i, i, vp,
    ]
    lib.vortex_grouped_gemm_tc_launch.restype = i
    lib.vortex_stage_launch.argtypes = [vp, vp]
    lib.vortex_stage_launch.restype = i


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed (a process
    lock and a file lock keep concurrent builders from racing)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            target = BUILD_DIR / f"libvortex_kernels-{source_digest()}.so"
            with open(BUILD_DIR / "build.lock", "w") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                if not target.exists():
                    _build(target)
            lib = ctypes.CDLL(str(target))
            _declare(lib)
            _lib = lib
    return _lib
