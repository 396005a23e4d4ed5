"""Plain PyTorch versions of the kernels (counterpart of repro/kernels/ref.py).

These are the semantic ground truth of the port: the CPU tests hold them
against the Pallas kernels run with ``interpret=True``, the kernel
wrappers use them for tensors that lie on the CPU, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.placement import is_dtensor

__all__ = [
    "ref_gemm",
    "ref_grouped_gemm",
    "ref_attention",
    "chunked_attention",
    "ref_conv2d",
    "ref_conv1d",
]

_NEG = -1e30


def ref_gemm(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """A @ B accumulated in float32, cast to ``out_dtype`` (default A's)."""
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)


def ref_grouped_gemm(
    x: torch.Tensor, w: torch.Tensor, counts=None, out_dtype=None
) -> torch.Tensor:
    """out[g] = x[g] @ w[g // (G // E)], accumulated in float32.

    x ``(G, C, K)``, w ``(E, K, N)``; groups are expert-major (``r = G//E``
    consecutive groups share a weight stack entry).  ``counts`` (optional
    ``(G,)`` int) marks each group's real rows: rows at or past it may hold
    anything, NaN included, and are SELECTED to zero (not multiplied by
    zero) before the product, so the matching output rows are exactly 0.
    """
    G, C, K = x.shape
    E = w.shape[0]
    xf = x.float()
    if counts is not None:
        valid = (
            torch.arange(C, device=x.device)[None, :]
            < _as_i32(counts, x.device).reshape(G, 1)
        )
        xf = torch.where(valid[..., None], xf, 0.0)
    out = torch.einsum(
        "erck,ekn->ercn", xf.reshape(E, G // E, C, K), w.float()
    )
    return out.reshape(G, C, -1).to(out_dtype or x.dtype)


def _as_i32(x, device) -> torch.Tensor:
    if isinstance(x, int):
        # A fill on the device, not a host-to-device copy: the plain
        # versions run inside captured CUDA graphs (MLA's prefill).
        return torch.full((), x, dtype=torch.int32, device=device)
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _mask(
    sq: int, skv: int, causal: bool, window: int | None, offset=0,
    kv_len=None, device=None,
) -> torch.Tensor:
    """(sq, skv) boolean mask.  ``offset`` is the absolute position of query
    row 0; ``kv_len`` the runtime number of valid keys (rows past it are
    bucket pad)."""
    q_pos = offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if kv_len is not None:
        m = m & (k_pos < kv_len)
    if causal:
        m = m & (k_pos <= q_pos)
    if window is not None:
        m = m & (q_pos - k_pos < window)
    return m


def ref_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    offset=0,
    kv_len=None,
) -> torch.Tensor:
    """Exact attention with the full score matrix (q (b, hq, sq, d), k/v
    (b, hkv, skv, d)).  ``kv_len`` and ``offset`` are scalars shared by the
    batch or (b,) vectors, one per batch row.  Value rows past ``kv_len``
    are zeroed (0 * NaN would poison real rows) and masked scores are
    -1e30, so a kv_len of 0 gives an exactly-zero row."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    dev = q.device
    kx = k.repeat_interleave(group, dim=1) if group > 1 else k
    vx = v.repeat_interleave(group, dim=1) if group > 1 else v
    off = _as_i32(offset, dev)
    kv = None if kv_len is None else _as_i32(kv_len, dev)
    per_row = off.ndim == 1 or (kv is not None and kv.ndim == 1)
    k_idx = torch.arange(skv, device=dev)
    if kv is not None:
        valid = k_idx[None, :] < kv.reshape(-1, 1)  # (rows, skv)
        vx = torch.where(valid[:, None, :, None], vx, 0.0)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * (d ** -0.5)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if per_row:
        q_pos = off.reshape(-1, 1, 1) + torch.arange(sq, device=dev)[None, :, None]
        k_pos = k_idx[None, None, :]
        m = torch.ones((1, sq, skv), dtype=torch.bool, device=dev)
        if kv is not None:
            m = m & (k_pos < kv.reshape(-1, 1, 1))
        if causal:
            m = m & (k_pos <= q_pos)
        if window is not None:
            m = m & (q_pos - k_pos < window)
        s = torch.where(m[:, None], s, _NEG)
    else:
        m = _mask(sq, skv, causal, window, off, kv_len=kv, device=dev)
        s = torch.where(m[None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx.float())
    return out.to(q.dtype)


def _on_local_heads(q, k, v, rules, **kw) -> torch.Tensor:
    """:func:`chunked_attention` over DTensors, each rank on its own shard.

    q, K and V are laid out alike on the batch and heads: q and K/V are
    first pinned on ``heads_act`` and ``kv_heads_act`` as the reference
    pins them (``pin`` and ``pin5``, src/repro/kernels/ref.py:182-205),
    then K/V, expanded to q's heads, on ``heads_act``.  Where the kv heads
    do not divide the model axis (8 or 4 over 16) K/V stay replicated on
    it while q's heads are sharded; the expanded K/V's pin is then a
    local slice, and its backward all-gathers the cotangent before
    ``repeat_interleave``'s backward sums the group.  Unpinned, that sum
    viewed the head-sharded cotangent, (b, hq, chunk, hd) -> (b, hkv,
    group, chunk, hd), which DTensor refuses for hkv = 8 over 16 ("Cannot
    unflatten unevenly sharded tensor", ROADMAP C17), and in a prefill
    DTensor ran every head on every rank (C20).  Where the q heads do not
    divide the model axis either (24 or 12 over 16), q's rows take it, as
    GSPMD splits the reference's prefill attention over the queries: K/V
    stay whole, each rank's rows are offset by their first row, and K/V's
    cotangents are partial sums over the model axis.

    Every head and row being independent, the loop then runs on the
    local shards as plain tensors and its output takes q's layout: over
    DTensors its einsums flatten the batch and head dims, both sharded,
    which torch 2.11's DTensor refuses.  ``offset`` and ``kv_len`` are
    one for the batch (the model's prefill and train calls pass 0 and
    None)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.models.partitioning import constrain

    group = q.shape[1] // k.shape[1]
    rows = "seq" if rules.rules.get("heads_act") is None else None
    q = constrain(q, rules, "batch", "heads_act", rows, None)
    k, v = (constrain(t, rules, "batch", "kv_heads_act", None, None)
            for t in (k, v))
    if group > 1:
        k, v = (t.repeat_interleave(group, dim=1) for t in (k, v))
    k, v = (constrain(t, rules, "batch", "heads_act", None, None)
            for t in (k, v))
    ql, offset, kv_grads = q.to_local(), kw.pop("offset"), []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        on_rows = isinstance(pq, Shard) and pq.dim == 2
        if on_rows:
            offset = offset + q.device_mesh.get_local_rank(i) * ql.shape[2]
        kv_grads.append(Partial() if on_rows else pk)
    out = chunked_attention(
        ql, k.to_local(grad_placements=kv_grads),
        v.to_local(grad_placements=kv_grads), offset=offset, **kw)
    shape = q.shape[:-1] + v.shape[-1:]
    return DTensor.from_local(
        out, q.device_mesh, q.placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    chunk: int = 1024,
    offset=0,
    kv_len=None,
    rules=None,
) -> torch.Tensor:
    """Online-softmax attention over kv chunks of ``chunk`` rows, never
    materializing the (sq, skv) scores; same masking contract as
    :func:`ref_attention`.  A Python loop stands in for the reference's
    ``lax.scan``.

    With ``rules`` (an ``AxisRules`` on a mesh) and DTensor operands the
    loop runs on each rank's own rows and heads (:func:`_on_local_heads`);
    plain tensors ignore ``rules``."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    if skv <= chunk:
        return ref_attention(
            q, k, v, causal=causal, window=window, softcap=softcap,
            offset=offset, kv_len=kv_len,
        )
    if rules is not None and rules.mesh is not None and is_dtensor(q):
        return _on_local_heads(
            q, k, v, rules, causal=causal, window=window, softcap=softcap,
            chunk=chunk, offset=offset, kv_len=kv_len)
    dev = q.device
    skv_true = skv
    pad = -skv % chunk
    if pad:  # padded positions are masked out below
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        skv += pad
    scale = d ** -0.5
    off = _as_i32(offset, dev)
    kv = None if kv_len is None else _as_i32(kv_len, dev)
    per_row = off.ndim == 1 or (kv is not None and kv.ndim == 1)
    q_pos = (
        off.reshape(-1, 1) + torch.arange(sq, device=dev)[None]  # (b, sq)
        if per_row else off + torch.arange(sq, device=dev)
    )
    limit = (
        torch.full((), skv_true, dtype=torch.int32, device=dev) if kv is None
        else torch.clamp(kv, max=skv_true)
    )
    qf = q.float()
    m_i = torch.full((b, hq, sq), _NEG, dtype=torch.float32, device=dev)
    l_i = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, sq, dv), dtype=torch.float32, device=dev)
    for ci in range(skv // chunk):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk]
        vb = v[:, :, ci * chunk:(ci + 1) * chunk]
        if group > 1:
            kb = kb.repeat_interleave(group, dim=1)
            vb = vb.repeat_interleave(group, dim=1)
        kb, vb = kb.float(), vb.float()
        k_pos = ci * chunk + torch.arange(chunk, device=dev)
        if per_row:
            lim = torch.broadcast_to(limit.reshape(-1), (b,))
            valid = k_pos[None, :] < lim[:, None]  # (b, chunk)
        else:
            valid = k_pos < limit
        if kv is not None:
            vzero = valid[:, None, :, None] if per_row else valid[None, None, :, None]
            vb = torch.where(vzero, vb, 0.0)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        if per_row:
            msk = torch.broadcast_to(valid[:, None, :], (b, sq, chunk))
            if causal:
                msk = msk & (k_pos[None, None, :] <= q_pos[:, :, None])
            if window is not None:
                msk = msk & (q_pos[:, :, None] - k_pos[None, None, :] < window)
            s = torch.where(msk[:, None], s, _NEG)
        else:
            msk = torch.broadcast_to(valid[None, :], (sq, chunk))
            if causal:
                msk = msk & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                msk = msk & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(msk[None, None], s, _NEG)
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        alpha = torch.exp(m_i - m_new)
        p = torch.exp(s - m_new[..., None])
        l_i = l_i * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m_i = m_new
    out = acc / torch.clamp(l_i, min=1e-30)[..., None]
    return out.to(q.dtype)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _check_padding(padding: str) -> None:
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def ref_conv1d(
    x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: str = "SAME"
) -> torch.Tensor:
    """(b, t, cin) * (kw, cin, cout) -> (b, t', cout), in ``x``'s dtype.
    On the card a float32 convolution may run in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False."""
    _check_padding(padding)
    xt = x.permute(0, 2, 1)
    if padding == "SAME":
        xt = torch.nn.functional.pad(xt, _same_pads(x.shape[1], w.shape[0], stride))
    out = torch.nn.functional.conv1d(xt, w.permute(2, 1, 0), stride=stride)
    return out.permute(0, 2, 1)


def ref_conv2d(
    x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: str = "SAME"
) -> torch.Tensor:
    """(b, h, w, cin) * (kh, kw, cin, cout) -> (b, h', w', cout), in
    ``x``'s dtype (same TF32 note as :func:`ref_conv1d`)."""
    _check_padding(padding)
    xt = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph = _same_pads(x.shape[1], w.shape[0], stride)
        pw = _same_pads(x.shape[2], w.shape[1], stride)
        xt = torch.nn.functional.pad(xt, (*pw, *ph))
    out = torch.nn.functional.conv2d(xt, w.permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1)
