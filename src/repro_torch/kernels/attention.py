"""Masked-tail flash attention: the wrapper of the attention kernels.

Replaces the Pallas TPU kernel ``flash_attention`` (src/repro/kernels/
attention.py, body ``_attn_kernel``) in both its forms: prefill (a query
block against the keys) and decode (``sq == 1``, ``block_q == 1``, the
query at ``q_offset = kv_len - 1``).  Same function: online softmax,
GQA, per-row or shared ``[kv_len, q_offset]``, key-validity, causal and
window masks at the finite -1e30, value rows past ``kv_len`` zeroed, the
denominator floored at 1e-30.

Three CUDA kernels, one per path (:func:`attention_path`), fixed before the
launch from the form, the selected strategy's backend and the dtype:

* ``prefill.tensor_core`` (bf16 prefill at a ``tensor_core`` strategy):
  ``csrc/attention_tc.cu``, wgmma tiles for Q K^T and P V, planned by
  :func:`tensor_core_attention_plan`;
* ``prefill.cuda_core`` (a ``cuda_core`` strategy, or float32 at either
  backend: Hopper has no exact f32 tensor-core product):
  ``csrc/attention.cu``, f32 FMAs on the CUDA cores;
* ``decode.split_kv`` (the decode form at both backends and dtypes):
  ``csrc/attention_decode.cu``, split-kv with the GQA group folded into the
  CTA.  One query row, or ``group`` rows once the group is folded, would
  fill 1-2 of wgmma's 64 rows, and decode reads each K/V byte once, so its
  bound is bytes, not tensor-core operations.

A tensor on the CPU takes :func:`flash_attention_plain`; a CUDA tensor
launches the path's kernel or raises.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.gemm import BACKENDS, SMEM_PER_BLOCK, validate_blocks
from repro_torch.kernels.ref import ref_attention

__all__ = [
    "flash_attention", "flash_attention_plain", "flash_decode_split_plain",
    "attention_smem_bytes", "AttentionTcPlan", "tensor_core_attention_plan",
    "attention_form", "check_attention_backend", "attention_path",
    "decode_splits", "LAUNCHES",
]

# Launches of the CUDA kernels, counted where they are launched and nowhere
# else: the totals by form, and each path (``attention_path``) on its own.
LAUNCHES = {
    "flash_attention_prefill": 0, "flash_attention_decode": 0,
    "flash_attention_prefill.tensor_core": 0,
    "flash_attention_prefill.cuda_core": 0,
    "flash_attention_decode.split_kv": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256  # 32 accumulator registers x 8 lanes per row
_NEG = -1e30


def attention_smem_bytes(block_q: int, block_k: int, head_dim: int) -> int:
    """Shared memory one block of csrc/attention.cu uses (mirrors its
    launch: Q, K, V and the probability tile, all f32)."""
    qs, ks = min(block_q, 16), min(block_k, 64)
    return (qs * head_dim + 2 * ks * head_dim + qs * ks) * 4


class AttentionTcPlan(NamedTuple):
    """How csrc/attention_tc.cu runs one (block_q, block_k) tile at a head
    width: ``warpgroups`` warpgroups, each owning one 64-row atom of a
    round, ``rounds`` rounds over the block's rows, ``smem_bytes`` of shared
    memory, and ``acc_per_thread`` f32 registers of O and S a thread."""

    warpgroups: int
    rounds: int
    smem_bytes: int
    acc_per_thread: int

    @property
    def threads(self) -> int:
        return 128 * self.warpgroups


def tensor_core_attention_plan(
    block_q: int, block_k: int, head_dim: int
) -> AttentionTcPlan:
    """The launch plan of the wgmma prefill kernel, or ValueError when it
    cannot honour the tile (it is never clamped).

    ``block_q`` is a multiple of wgmma's 64 rows, ``block_k`` of its k16,
    ``head_dim`` a multiple of 8 up to 256.  Q and K sit in shared tiles
    ``dp`` = head_dim rounded up to 16 wide, their pad columns zero (they
    add nothing to Q K^T); P V runs at n = head_dim (ROADMAP C3: 120 is
    h2o-danube3's head width).  The CTA has at most 4 warpgroups, fewer for
    wide heads (2 up to d = 128, 1 above) so that the O fragment (d/2
    floats) and the S fragment of a 64-key sub-step (32 floats) stay in
    registers.  Shared memory holds one round's Q and a 2-slot K/V ring:
    2*(64*warpgroups*dp + 2*block_k*(dp + d)) bytes.
    """
    if block_q % 64 or block_k % 16:
        raise ValueError(
            f"tensor_core attention tile ({block_q}, {block_k}) is not a "
            "multiple of wgmma's (64 rows, 16 keys)"
        )
    if head_dim % 8 or not 8 <= head_dim <= 256:
        raise ValueError(
            f"tensor_core attention needs a head_dim that is a multiple of 8 "
            f"up to 256, got {head_dim}"
        )
    atoms = block_q // 64
    max_wg = 4 if head_dim <= 64 else (2 if head_dim <= 128 else 1)
    wg = min(atoms, max_wg)
    dp = -(-head_dim // 16) * 16
    smem = 2 * (64 * wg * dp + 2 * block_k * (dp + head_dim))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"tensor_core attention tile ({block_q}, {block_k}) at head_dim "
            f"{head_dim} needs {smem} bytes of shared memory; a block has "
            f"{SMEM_PER_BLOCK}"
        )
    return AttentionTcPlan(wg, -(-atoms // wg), smem, head_dim // 2 + 32)


def attention_form(sq: int, block_q: int) -> str:
    """``decode`` for one query row at block_q == 1, else ``prefill``."""
    return "decode" if sq == 1 and block_q == 1 else "prefill"


def check_attention_backend(
    form: str, backend: str, block_q: int, block_k: int, head_dim: int
) -> AttentionTcPlan | None:
    """Validate the (form, backend, tile, head_dim) tuple: the wgmma plan
    for prefill at ``tensor_core``, None for every other pair (the FMA
    prefill loop and the split-kv decode kernel take any positive tile)."""
    if backend not in BACKENDS:
        raise ValueError(
            f"flash_attention: unknown backend {backend!r}; the kernels "
            f"serve {BACKENDS}"
        )
    if form == "decode" or backend == "cuda_core":
        return None
    try:
        return tensor_core_attention_plan(block_q, block_k, head_dim)
    except ValueError as e:
        raise ValueError(f"flash_attention: {e}") from None


def attention_path(
    form: str, plan: AttentionTcPlan | None, dtype: torch.dtype
) -> str:
    """The kernel a launch takes, fixed before it: ``decode.split_kv`` for
    the decode form; ``prefill.tensor_core`` for bf16 prefill at a
    ``tensor_core`` strategy; ``prefill.cuda_core`` otherwise."""
    if form == "decode":
        return "decode.split_kv"
    if plan is not None and dtype == torch.bfloat16:
        return "prefill.tensor_core"
    return "prefill.cuda_core"


def decode_splits(
    rows: int, kv_keys: int, block_k: int, sms: int
) -> tuple[int, int]:
    """(keys per split, number of splits) of the decode kernel for ``rows``
    (batch row, kv head) pairs over ``kv_keys`` keys: as few whole
    ``block_k``-key blocks a split as cover ``sms`` SMs with
    ``rows * splits`` CTAs, never more splits than blocks."""
    blocks = max(1, -(-kv_keys // block_k))
    want = max(1, -(-sms // max(rows, 1)))
    per = -(-blocks // min(want, blocks))
    return per * block_k, -(-blocks // per)


def flash_attention_plain(
    q, k, v, kv_len=None, q_offset=None, *, causal=True, window=None,
    softcap=None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (full score matrix)."""
    return ref_attention(
        q, k, v, causal=causal, window=window, softcap=softcap,
        offset=0 if q_offset is None else q_offset, kv_len=kv_len,
    )


def flash_decode_split_plain(
    q, k, v, kv_len=None, q_offset=None, split: int = 64, *, causal=True,
    window=None, softcap=None,
) -> torch.Tensor:
    """The decode kernel's split-kv scheme in plain PyTorch.

    The keys are cut into splits of ``split`` keys.  Each split keeps the
    partials (m, l, acc) of its valid keys only -- the masked ones get
    exactly 0 weight and value rows past ``kv_len`` are zeroed -- and the
    splits merge by the log-sum-exp rule, the denominator floored at
    1e-30.  Wherever a row has a valid key this is :func:`ref_attention`'s
    function; a row with none (``kv_len == 0``) is exactly zero.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    dev = q.device
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    off = torch.as_tensor(0 if q_offset is None else q_offset,
                          dtype=torch.int32, device=dev).reshape(-1, 1, 1)
    kv = torch.as_tensor(skv if kv_len is None else kv_len,
                         dtype=torch.int32, device=dev).reshape(-1, 1, 1)
    q_pos = off + torch.arange(sq, device=dev)[None, :, None]
    k_pos = torch.arange(skv, device=dev)[None, None, :]
    valid = k_pos < kv  # (rows, sq, skv), rows = 1 or b
    if causal:
        valid = valid & (k_pos <= q_pos)
    if window is not None:
        valid = valid & (q_pos - k_pos < window)
    valid = valid[:, None]  # over the heads
    vx = torch.where((k_pos[0, 0] < kv.reshape(-1, 1))[:, None, :, None],
                     vx, 0.0)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * d ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid, s, _NEG)
    parts = []
    for k0 in range(0, skv, split):
        sl = slice(k0, k0 + split)
        m = s[..., sl].amax(-1, keepdim=True)
        p = torch.where(valid[..., sl], torch.exp(s[..., sl] - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True), p @ vx[:, :, sl]))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l_all = sum(l * torch.exp(m - m_all) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - m_all) for m, _, a in parts)
    return (acc / l_all.clamp_min(1e-30)).to(q.dtype)


def _is_scalar(x) -> bool:
    return isinstance(x, (int, np.integer)) or (
        isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim == 0
    )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# Split-kv tickets, one int32 per (batch row, kv head), by (device, stream):
# zero before a launch, and the launch leaves them zero.  A CUDA graph
# binds the buffer its capture found, so a buffer is allocated only outside
# a capture (the graph's eager warm-up step on the capture stream takes
# it), and one that a larger launch outgrows is retired, never freed: a
# graph captured against it may still replay.  Graphs replay in sequence
# on one stream, so they may share a buffer; they never replay
# concurrently on two streams.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
_RETIRED: list[torch.Tensor] = []


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_attention: the split-kv tickets of this stream are "
                "allocated outside a CUDA graph capture; run the step once "
                "eagerly on the capture stream first"
            )
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len=None,
    q_offset=None,
    *,
    block_q: int = 128,
    block_k: int = 128,
    backend: str = "cuda_core",
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Multi-head attention, q (b, hq, sq, d), k/v (b, hkv, skv, d).

    ``kv_len``/``q_offset`` are Python ints shared by the batch, or (b,)
    vectors (one extent per batch row).  Blocks are honoured verbatim.

    ``backend`` is the selected strategy's backend.  The (form, backend,
    tile, head_dim) tuple is validated first, on every device
    (:func:`check_attention_backend`): an unknown backend, or a
    ``tensor_core`` prefill tile the wgmma kernel cannot hold, raises
    ``ValueError``.  On the card the path is fixed before the launch
    (:func:`attention_path`).
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
    form = attention_form(sq, block_q)
    plan = check_attention_backend(form, backend, block_q, block_k, d)
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
    path = attention_path(form, plan, q.dtype)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    info_ptr = None if info is None else info.data_ptr()
    window_i = 0 if window is None else int(window)
    softcap_f = 0.0 if softcap is None else float(softcap)
    if path == "prefill.tensor_core":
        rc = lib.flash_attention_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            info_ptr, kv_s, off_s, b, hq, hkv, sq, skv, d, block_q, block_k,
            plan.warpgroups, plan.smem_bytes, int(causal), window_i,
            softcap_f, d ** -0.5, stream,
        )
    elif path == "prefill.cuda_core":
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            info_ptr, kv_s, off_s, b, hq, hkv, sq, skv, d, block_q, block_k,
            int(causal), window_i, softcap_f, d ** -0.5,
            _DTYPE_CODE[q.dtype], stream,
        )
    else:
        kv_keys = min(kv_s, skv) if info is None else skv
        split_keys, nsplit = decode_splits(
            b * hkv, kv_keys, block_k, _sm_count(q.device.index or 0))
        part = tickets = None
        if nsplit > 1:
            part = torch.empty(b * hkv * nsplit * (hq // hkv) * (d + 2),
                               dtype=torch.float32, device=q.device)
            tickets = _tickets(q.device, stream, b * hkv)
        rc = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            info_ptr, None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(), kv_s, off_s,
            b, hq, hkv, skv, d, int(causal), window_i, softcap_f, d ** -0.5,
            split_keys, nsplit, _DTYPE_CODE[q.dtype], stream,
        )
    if rc:
        raise RuntimeError(
            f"flash_attention: {path} kernel launch failed (cudaError {rc})"
        )
    LAUNCHES[f"flash_attention_{form}"] += 1
    LAUNCHES[f"flash_attention_{path}"] += 1
    return out
