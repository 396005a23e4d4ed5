"""Masked-tail flash attention: the wrapper of ``csrc/attention.cu``.

Replaces the Pallas TPU kernel ``flash_attention`` (src/repro/kernels/
attention.py, body ``_attn_kernel``) in both its forms: prefill (a query
block against the keys) and decode (``sq == 1``, ``block_q == 1``, the
query at ``q_offset = kv_len - 1``).  Same function: online softmax,
GQA, per-row or shared ``[kv_len, q_offset]``, key-validity, causal and
window masks at the finite -1e30, value rows past ``kv_len`` zeroed, the
denominator floored at 1e-30.

Bound on the H100: device-memory bytes at the served shapes (see the note
in csrc/attention.cu); the kernel stops each row block at its ``kv_len``
and causal frontier so it touches only the valid K/V rows.  A tensor on
the CPU takes :func:`flash_attention_plain`; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gemm import validate_blocks
from repro_torch.kernels.ref import ref_attention

__all__ = [
    "flash_attention", "flash_attention_plain", "attention_smem_bytes",
    "LAUNCHES",
]

# Launches of the CUDA kernel by form, counted where it is launched.
LAUNCHES = {"flash_attention_prefill": 0, "flash_attention_decode": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256  # 32 accumulator registers x 8 lanes per row


def attention_smem_bytes(block_q: int, block_k: int, head_dim: int) -> int:
    """Shared memory one block of csrc/attention.cu uses (mirrors its
    launch: Q, K, V and the probability tile, all f32)."""
    qs, ks = min(block_q, 16), min(block_k, 64)
    return (qs * head_dim + 2 * ks * head_dim + qs * ks) * 4


def flash_attention_plain(
    q, k, v, kv_len=None, q_offset=None, *, causal=True, window=None,
    softcap=None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (full score matrix)."""
    return ref_attention(
        q, k, v, causal=causal, window=window, softcap=softcap,
        offset=0 if q_offset is None else q_offset, kv_len=kv_len,
    )


def _is_scalar(x) -> bool:
    return isinstance(x, (int, np.integer)) or (
        isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim == 0
    )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len=None,
    q_offset=None,
    *,
    block_q: int = 128,
    block_k: int = 128,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Multi-head attention, q (b, hq, sq, d), k/v (b, hkv, skv, d).

    ``kv_len``/``q_offset`` are Python ints shared by the batch, or (b,)
    vectors (one extent per batch row).  Blocks are honoured verbatim.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not form a (GQA) attention call"
        )
    validate_blocks("flash_attention", block_q=block_q, block_k=block_k)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be >= 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap={softcap} must be > 0")
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, kv_len, q_offset, causal=causal, window=window,
            softcap=softcap,
        )
    if q.device.type != "cuda" or not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; the "
            "kernel takes float32 or bfloat16 for all three"
        )
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} > {_MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    kv = skv if kv_len is None else kv_len
    off = 0 if q_offset is None else q_offset
    info = None
    if _is_scalar(kv) and _is_scalar(off):
        kv_s, off_s = int(kv), int(off)
    else:
        # Per-row extents ride as a device (2, b) int32 array.
        rows = [
            torch.as_tensor(x, dtype=torch.int32, device=q.device)
            .reshape(-1).expand(b)
            for x in (kv, off)
        ]
        info = torch.stack(rows).contiguous()
        kv_s = off_s = 0
    from repro_torch.kernels.build import library

    lib = library()
    out = torch.empty_like(q)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if info is None else info.data_ptr(), kv_s, off_s,
        b, hq, hkv, sq, skv, d, block_q, block_k, int(causal),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), d ** -0.5,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(
            f"flash_attention: kernel launch failed (cudaError {rc})"
        )
    form = "decode" if sq == 1 and block_q == 1 else "prefill"
    LAUNCHES[f"flash_attention_{form}"] += 1
    return out
