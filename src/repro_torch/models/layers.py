"""The decoder layers (counterpart of src/repro/models/layers.py).

Attention, multi-head latent attention (MLA), the Mamba-1 selective SSM,
dense MLPs and top-k routed MoE.  Every mixer/MLP is a plain function
``(params, x, ...) -> y`` on tensors, in three modes:

  * ``prefill`` — the full (bucket-padded) sequence, emitting a decode cache
    of length ``cache_len``,
  * ``decode``  — one new token against the cache at ``pos``: one position
    for the batch, or a (b,) vector of per-row positions (continuous
    batching),
  * ``train``   — what prefill computes, with no cache, every op plain
    torch under autograd: attention always takes the inline
    ``chunked_attention`` and the experts their einsums, never an engine
    dispatch (the kernels are ctypes calls with no backward), and the
    Mamba scan recomputes each chunk in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per
    chunk, src/repro/models/layers.py:734-749).

With a :mod:`repro_torch.vortex` session installed, prefill attention and
each decode token's attention are served by the engine (the lattice picks
the kernel's tiles; on the card they launch the hand-written kernels),
exactly where the reference routes them; without one the plain chunked
attention runs inline.  Likewise each MoE layer serves its experts through
three ``grouped_gemm`` dispatches (one launch per projection for all
experts) under a session, and through inline einsums without one.  The
dense projections are plain matmuls, as the JAX package leaves them to XLA,
except in the lazy handle chain (``block_forward_lazy``, the server's
``prefill="chained"``), where every projection is an engine ``gemm``
dispatch.

Whisper's encoder attention (non-causal) goes through the engine too.
Cross-attention (through the inline ``chunked_attention``), MLA's prefill
attention (naive form, the same), its absorbed decode and the whole Mamba
mixer are plain torch on every device, as the reference leaves them to
inline XLA.
A Mamba prefill leaves the state of the last REAL prompt token, where the
reference scans the bucket pad into it (ROADMAP C11).

Sharding is expressed through logical-axis constraints
(models/partitioning.py ``constrain``), at the reference's places: they
redistribute DTensor activations and leave plain tensors untouched.
A decode whose attention cache is sequence-sharded over the model axis
runs :func:`flash_decode_sharded`: each rank attends over its own cache
rows and the partial softmaxes merge with three all-reduces.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import LazyBucket, lazy_map
from repro_torch.kernels.ref import chunked_attention
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.partitioning import (
    AxisRules,
    PartitionSpec,
    constrain,
    is_dtensor,
    on_local_shards,
    spec_to_placements,
)
from repro_torch.vortex import _deprecation, session

__all__ = [
    "set_attention_engine",
    "get_attention_engine",
    "attention_engine",
    "rmsnorm",
    "layernorm",
    "norm",
    "rope_tables",
    "sinusoid",
    "apply_rope",
    "PerRowPosError",
    "flash_decode_shard",
    "flash_decode_sharded",
    "attn_forward",
    "mla_forward",
    "mamba_forward",
    "mlp_forward",
    "lazy_matmul",
    "attn_forward_lazy",
    "mlp_forward_lazy",
    "block_forward_lazy",
    "route",
    "moe_capacity",
    "moe_forward",
    "ATTN_CHUNK",
]

# KV-chunk length of the inline (sessionless) online-softmax attention.
ATTN_CHUNK = 1024

_MODES = ("prefill", "decode", "train")


# set_attention_engine / get_attention_engine / attention_engine are the
# deprecated pre-session surface (src/repro/models/layers.py:69-106); they
# read and write the same context variable as vortex.use.


def set_attention_engine(engine):
    """Deprecated: install (or clear, with None) the engine
    :func:`attn_forward` routes prefill attention through; returns the
    previous one.  Use ``vortex.use(engine)``: scoped, exception-safe and
    local to the calling context (this shim writes the same context-local
    session)."""
    _deprecation.warn_deprecated(
        "models.layers.set_attention_engine",
        "repro_torch.vortex.use(engine) (NOTE the shim writes the "
        "context/thread-local session, not a process-wide global: "
        "multi-threaded harnesses must install per serving thread)",
    )
    return session.install(engine)


def get_attention_engine():
    """Deprecated: the engine :func:`attn_forward` currently routes
    through, or None.  Use ``repro_torch.vortex.installed_engine()``."""
    _deprecation.warn_deprecated(
        "models.layers.get_attention_engine",
        "repro_torch.vortex.installed_engine()",
    )
    return session.installed_engine()


@contextlib.contextmanager
def attention_engine(engine):
    """Deprecated: scoped engine install.  Use ``vortex.use(engine)``
    (this shim delegates to it)."""
    _deprecation.warn_deprecated(
        "models.layers.attention_engine", "repro_torch.vortex.use(engine)"
    )
    with session.use(engine):
        yield engine


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w


def norm(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rmsnorm(x, w) if cfg.norm == "rmsnorm" else layernorm(x, w)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(
    positions: torch.Tensor, dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., dim/2) cos/sin tables for integer positions."""
    half = dim // 2
    freq = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper's absolute positions: (..., dim) f32, the sines of
    ``dim/2`` frequencies then their cosines (concatenated, not
    interleaved; src/repro/models/model.py:271-286)."""
    half = dim // 2
    freq = 10000.0 ** (
        -torch.arange(half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate pairs (split-half convention). x: (..., seq, dim);
    cos/sin: (seq, dim/2) broadcastable."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    if is_dtensor(x):
        # The same values; a head-sharded gradient comes back through a
        # stack and a split, where the transposed view's backward fails
        # in DTensor's local view.
        return torch.stack(x.split(x.shape[-1] // n, dim=-1), dim=1)
    # Contiguous: the kernels take dense (b, h, s, hd) tensors.
    return x.reshape(b, s, n, -1).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor, rules: AxisRules | None = None
                 ) -> torch.Tensor:
    """(b, h, s, hd) -> (b, s, h * hd).  With ``rules`` the merged heads
    are laid out ``(batch, None, heads_act)``: forward, it gathers the
    rows that ``chunked_attention`` sharded where the heads do not divide
    the model axis; backward, it brings the output projection's
    cotangent, sharded over the flat width, to the heads' own layout
    before the reshape's backward views it as (b, s, h, hd).  With 24
    heads over 16 (phi4-mini) that view failed on the flat shard ("Cannot
    unflatten unevenly sharded tensor", ROADMAP C18)."""
    b, h, s, hd = x.shape
    out = x.transpose(1, 2).reshape(b, s, h * hd)
    return constrain(out, rules, "batch", None, "heads_act")


def _window_slice(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    window: int,
):
    """The last ``window`` cache rows up to each row's ``pos`` (the
    reference's static window slice, src/repro/models/layers.py:185-215,
    per row): ``(k, v, start)``, k/v ``(b, KV, window, hd)``, ``start`` the
    (b,) absolute position of each row's row 0.

    A gather copy of ``window`` rows per (row, kv head): the kernels take
    dense caches.
    """
    b, hkv, S, _ = k_cache.shape
    start = (pos - window + 1).clamp(0, S - window)
    idx = start[:, None] + torch.arange(window, device=pos.device)
    idx = idx[:, None, :, None].long()
    k = torch.gather(k_cache, 2, idx.expand(b, hkv, window, k_cache.shape[-1]))
    v = torch.gather(v_cache, 2, idx.expand(b, hkv, window, v_cache.shape[-1]))
    return k, v, start


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` with ``pad`` zero rows appended to its second-to-last (the
    cache's sequence) axis.  Over a DTensor whose sequence axis is not
    sharded each rank pads its own shard: torch 2.11's DTensor gives
    ``F.pad``'s output one placement on a mesh of several dims, which
    ``torch.stack`` then refuses."""
    if not pad:
        return t
    if is_dtensor(t):
        from torch.distributed.tensor import DTensor, Shard

        ax = t.ndim - 2
        pl = tuple(t.placements)
        if len(pl) == t.device_mesh.ndim and not any(
                isinstance(p, Shard) and p.dim % t.ndim == ax for p in pl):
            shape = t.shape[:ax] + (t.shape[ax] + pad, t.shape[-1])
            return DTensor.from_local(
                F.pad(t.to_local(), (0, 0, 0, pad)), t.device_mesh, pl,
                run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
    return F.pad(t, (0, 0, 0, pad))


def _write_rows(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor, axis: int) -> None:
    """In place, for every batch row ``r``: the cache's row ``r`` at
    position ``pos[r]`` on its sequence ``axis`` becomes ``new[r]``
    (``new`` is the cache's shape without ``axis``): the (rows, pos) index
    pairs select one cache row per batch row.  Over a DTensor cache each
    rank writes what its own shard holds (DTensor has no in-place
    ``index_put_`` that keeps a sharded layout): the rows of its batch
    slice whose position falls in its slice of the sequence."""
    lead = (slice(None),) * (axis - 1)
    if not is_dtensor(cache):
        rows = torch.arange(new.shape[0], device=pos.device)
        cache[(rows,) + lead + (pos.long(),)] = new.to(cache.dtype)
        return
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    # The shard's extent and offset depend on the placements alone, but
    # torch reads them through a small index tensor, which FakeTensorMode
    # refuses as data-dependent (``_local_scalar_dense``, ROADMAP C19):
    # they are computed with fake mode lifted, a no-op outside it.
    with unset_fake_temporarily():
        shape, off = compute_local_shape_and_global_offset(
            cache.shape, cache.device_mesh, cache.placements)
    full = new.full_tensor() if is_dtensor(new) else new
    for i, d in enumerate(d for d in range(cache.ndim) if d != axis):
        full = full.narrow(i, off[d], shape[d])
    pos = pos.full_tensor() if is_dtensor(pos) else pos
    at = pos.expand(cache.shape[0]).narrow(0, off[0], shape[0]).long()
    at = at - off[axis]
    valid = ((at >= 0) & (at < shape[axis])).view((-1,) + (1,) * (full.ndim - 1))
    local = cache.to_local()
    idx = (torch.arange(shape[0], device=local.device),) + lead + (
        at.clamp(0, shape[axis] - 1),)
    local[idx] = torch.where(valid, full.to(local.dtype), local[idx])


def _decode_attend(
    q: torch.Tensor,        # (b, H, 1, hd)
    k_cache: torch.Tensor,  # (b, KV, S, hd)
    v_cache: torch.Tensor,  # (b, KV, S, dv)
    pos: torch.Tensor,      # (b,) index of each row's new token
    window: int | None,
    softcap: float | None,
    scale: float,
) -> torch.Tensor:
    b, hq, _, hd = q.shape
    _, hkv, S, _ = k_cache.shape
    group = hq // hkv

    # A sliding-window layer reads only the last ``window`` positions: once
    # the cache is longer than twice the window, slice them out and rebase
    # the positions (as the reference does), so the decode dispatch sees the
    # reference's extent and bucket.
    base = 0
    if window is not None and S > 2 * window:
        k_cache, v_cache, base = _window_slice(k_cache, v_cache, pos, window)
        S = window

    # Engine-served decode: the query dispatches through the kv_len-masked
    # decode workload at the (bucketed) cache length S, with the valid row
    # count as a runtime (b,) extent -- rows may be at mixed progress, one
    # launch for the whole batch -- so cache tails past the last written
    # token may hold anything.  The inline math below serves sessionless
    # callers and the shapes the workload does not cover (dv != hd, a
    # non-default scale).
    engine = session.installed_engine()
    if (
        engine is not None
        and v_cache.shape[-1] == hd
        and abs(scale - hd ** -0.5) < 1e-12
    ):
        return engine.dispatch(
            "decode_attention", q, k_cache, v_cache, pos - base + 1,
            window=window, softcap=softcap,
        ).to(q.dtype)

    # Inline: masks SCORES only, so cache tails must be finite here.
    qf = q.float().reshape(b, hkv, group, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(S, device=q.device)[None] + torch.as_tensor(
        base, device=q.device).reshape(-1, 1)          # (b or 1, S)
    p_ = pos[:, None]
    mask = k_pos <= p_
    if window is not None:
        mask = mask & (k_pos > p_ - window)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return out.reshape(b, hq, 1, -1).to(q.dtype)


class PerRowPosError(ValueError):
    """A per-row decode position reached the sequence-sharded decode,
    which takes one position for the whole batch (ROADMAP C15: the
    reference's ``flash_decode_sharded`` fails on a (b,) ``pos`` too)."""


def flash_decode_shard(
    q: torch.Tensor,        # (b, H, 1, hd)
    k_cache: torch.Tensor,  # (b, KV, s_loc, hd): this rank's cache rows
    v_cache: torch.Tensor,  # (b, KV, s_loc, dv)
    k_new: torch.Tensor,    # (b, KV, 1, hd)
    v_new: torch.Tensor,    # (b, KV, 1, dv)
    pos,
    *,
    base: int,
    window: int | None,
    softcap: float | None,
    scale: float,
    group=None,
) -> torch.Tensor:
    """One rank's part of the sequence-sharded flash decode (the body of
    the reference's ``shard_map``, src/repro/models/layers.py:316-345) on
    plain tensors: the rank holds cache rows ``base .. base + s_loc - 1``.

    (a) The new K/V row is written IN PLACE at ``pos`` when this rank owns
    it; (b) a partial online softmax in float32 over the rank's rows; (c)
    the partials merge over ``group`` with an all-reduce MAX of the row
    maxima, then SUM of the sums and of the (b, KV, group, dv) outputs:
    bytes per step O(heads x head_dim), not O(cache).  ``pos`` is one
    position for the batch (an int or a 0-d tensor); a (b,) tensor raises
    :class:`PerRowPosError`.  Returns ``(b, H, 1, dv)`` in ``q``'s
    dtype."""
    import torch.distributed as dist

    if torch.is_tensor(pos) and pos.ndim:
        raise PerRowPosError(
            f"the sequence-sharded decode takes one position, got pos of "
            f"shape {tuple(pos.shape)}")
    b, hq, _, hd = q.shape
    _, hkv, s_loc, dv = v_cache.shape
    grp = hq // hkv
    dev = q.device
    pos_t = torch.as_tensor(pos, device=dev)
    off = pos_t - base
    owned = (off >= 0) & (off < s_loc)
    safe = off.clamp(0, s_loc - 1).long()
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        row = c.index_select(2, safe.reshape(1))
        c.index_copy_(2, safe.reshape(1),
                      torch.where(owned, new.to(c.dtype), row))

    k_pos = base + torch.arange(s_loc, device=dev)
    qf = q.float().reshape(b, hkv, grp, hd)
    sc = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.float()) * scale
    if softcap is not None:
        sc = torch.tanh(sc / softcap) * softcap
    mask = k_pos <= pos_t
    if window is not None:
        mask = mask & (k_pos > pos_t - window)
    sc = torch.where(mask[None, None, None, :], sc, -1e30)
    m = sc.amax(dim=-1)
    dist.all_reduce(m, dist.ReduceOp.MAX, group=group)
    pr = torch.exp(sc - m[..., None])
    l_sum = pr.sum(dim=-1)
    dist.all_reduce(l_sum, dist.ReduceOp.SUM, group=group)
    o = torch.einsum("bkgs,bksd->bkgd", pr, v_cache.float())
    dist.all_reduce(o, dist.ReduceOp.SUM, group=group)
    out = o / l_sum.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, 1, dv).to(q.dtype)


def flash_decode_sharded(
    q: torch.Tensor,        # (b, H, 1, hd)
    k_cache: torch.Tensor,  # (b, KV, S, hd): seq-sharded over the TP axis
    v_cache: torch.Tensor,  # (b, KV, S, dv)
    k_new: torch.Tensor,    # (b, KV, 1, hd)
    v_new: torch.Tensor,    # (b, KV, 1, dv)
    pos,
    window: int | None,
    softcap: float | None,
    scale: float,
    rules: AxisRules,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed flash decode over DTensors (src/repro/models/layers.py:
    271-356): the caches are DTensors sharded on their sequence axis over
    the rules' ``seq`` mesh axis (and on batch over the batch axes, or
    not); ``q``, ``k_new`` and ``v_new`` are DTensors or replicated plain
    tensors.  Each rank runs :func:`flash_decode_shard` on its local rows,
    writing the caches in place.  Returns ``(out, k_cache, v_cache)``,
    ``out`` a DTensor laid out ``(batch, None, None, None)``."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = rules.mesh
    seq_ax = rules.rules.get("seq")
    b = q.shape[0]
    S = v_cache.shape[2]
    s_loc = S // rules.axis_sizes[seq_ax]
    bspec = rules.sanitize(PartitionSpec(rules.rules.get("batch")), (b,))
    flat = spec_to_placements(mesh, bspec)

    def local(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, flat).to_local()

    out = flash_decode_shard(
        local(q), k_cache.to_local(), v_cache.to_local(), local(k_new),
        local(v_new), pos, base=mesh.get_local_rank(seq_ax) * s_loc,
        window=window, softcap=softcap, scale=scale,
        group=mesh.get_group(seq_ax),
    )
    return DTensor.from_local(out, mesh, flat, run_check=False), \
        k_cache, v_cache


def _seq_sharded(rules: AxisRules | None, S: int) -> bool:
    """The reference's condition for the sharded decode (layers.py:
    417-424): a mesh whose model axis is > 1 and divides the cache length,
    and kv heads that do not divide it."""
    if rules is None or rules.mesh is None:
        return False
    model = rules.axis_sizes.get("model", 1)
    return (rules.rules.get("seq") is not None
            and rules.rules.get("kv_heads_act") is None
            and model > 1 and S % model == 0)


def attn_forward(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    spec: LayerSpec,
    *,
    mode: str,
    positions: torch.Tensor,
    cache: dict | None = None,
    pos: torch.Tensor | None = None,
    cache_len: int = 0,
    causal: bool = True,
    encoder_out: torch.Tensor | None = None,
    rules: AxisRules | None = None,
    uniform_pos=None,
) -> tuple[torch.Tensor, dict]:
    """GQA attention with RoPE, sliding window, logit softcap and
    cross-attention.

    ``positions`` are the RoPE positions: ``(s,)`` in prefill, ``(b, 1)``
    in decode.  ``pos`` is the (b,) decode position of each row.
    ``causal=False`` is whisper's encoder (src/repro/models/model.py:
    205-228); under a session it dispatches through the engine like every
    prefill attention, as the reference routes it (src/repro/models/
    layers.py:460-475).

    Returns ``(y, cache)``: in prefill the emitted k/v are padded to
    ``cache_len``; in decode the new token's k/v row is written INTO
    ``cache`` in place (the counterpart of the reference's
    ``dynamic_update_slice``) and the same dict comes back; in train the
    cache is None.

    With ``spec.cross_attn`` the layer then attends, non-causally, from
    ``norm(x + y)`` to ``encoder_out`` (b, encoder_seq, d), whose K/V it
    projects anew at every call, as the reference does (:493-502).  ``x``
    there is this function's input, the mixer's NORMED input, not the
    residual stream: the reference's quirk, kept.

    ``rules`` pins train-mode activations as the reference does; under a
    mesh whose cache is sequence-sharded (``_seq_sharded``) the decode
    runs :func:`flash_decode_sharded` at ``uniform_pos``, the batch's one
    position (None when the caller gave per-row positions: then
    :class:`PerRowPosError`).
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = _split_heads(x @ p["wq"], H)
    k = _split_heads(x @ p["wk"], KV)
    v = _split_heads(x @ p["wv"], KV)
    if mode == "train":
        q = constrain(q, rules, "batch", "heads_act", None, None)
        k = constrain(k, rules, "batch", "kv_heads_act", None, None)

    if cfg.use_rope:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        if positions.ndim == 2:
            # Decode positions (b, 1): tables (b, 1, hd/2) lifted to
            # (b, 1, 1, hd/2), so every row rotates at its own position.
            cos, sin = cos[:, None], sin[:, None]
        else:
            cos, sin = cos[None, None], sin[None, None]  # (1, 1, s, hd/2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    scale = hd ** -0.5
    if (mode == "decode" and cache is not None
            and _seq_sharded(rules, cache["k"].shape[2])):
        out, _, _ = flash_decode_sharded(
            q, cache["k"], cache["v"], k, v,
            pos if uniform_pos is None else uniform_pos, spec.window,
            cfg.attn_softcap, scale, rules,
        )
        new_cache = cache
    elif mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        # In place: the cache is this request's own (leased) buffer, or the
        # scheduler's shared one.
        # Each row's k/v lands at its own position: the (rows, pos) index
        # pairs select one cache row per batch row.
        _write_rows(cache["k"], k[:, :, 0], pos, 2)
        _write_rows(cache["v"], v[:, :, 0], pos, 2)
        out = _decode_attend(
            q, cache["k"], cache["v"], pos, spec.window, cfg.attn_softcap,
            scale,
        )
        new_cache = cache
    else:
        # Train mode never dispatches: the kernels have no backward, so
        # wq/wk/wv would get no gradient (the reference's trainer installs
        # no session, so its training takes the inline path too).
        engine = session.installed_engine() if mode == "prefill" else None
        if engine is not None:
            # Dynamic-seq serving path: the session engine selects
            # (block_q, block_k) from the scored lattice for this seq.
            out = engine.dispatch(
                "attention", q, k, v, causal=causal, window=spec.window,
                softcap=cfg.attn_softcap,
            )
        else:
            # The reference pins the loop in train mode only, and GSPMD
            # still splits a prefill's attention 16 ways; unpinned, DTensor
            # ran every head on every rank of the model axis (ROADMAP C20).
            # So a prefill takes the pins too.
            out = chunked_attention(
                q, k, v, causal=causal, window=spec.window,
                softcap=cfg.attn_softcap, chunk=ATTN_CHUNK, rules=rules,
            )
        new_cache = None
        if mode == "prefill":
            pad = cache_len - s
            new_cache = {
                "k": _pad_rows(k, pad),
                "v": _pad_rows(v, pad),
            }
    y = _merge_heads(out, None if mode == "decode" else rules) @ p["wo"]

    if spec.cross_attn:
        if encoder_out is None:
            raise ValueError("a cross-attention layer needs encoder_out")
        xn = norm(x + y, p["norm_x"], cfg)
        qx = _split_heads(xn @ p["xq"], H)
        kx = _split_heads(encoder_out @ p["xk"], KV)
        vx = _split_heads(encoder_out @ p["xv"], KV)
        ox = chunked_attention(qx, kx, vx, causal=False, chunk=ATTN_CHUNK,
                               rules=rules)
        y = y + _merge_heads(ox, rules) @ p["xo"]
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def _rope_at(positions: torch.Tensor, dim: int, theta: float):
    """RoPE tables lifted to (rows, 1, seq, dim/2): ``positions`` (s,) in
    prefill, (b, 1) in decode (each row at its own position)."""
    cos, sin = rope_tables(positions, dim, theta)
    if positions.ndim == 2:
        return cos[:, None], sin[:, None]
    return cos[None, None], sin[None, None]


def mla_forward(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,
    positions: torch.Tensor,
    cache: dict | None = None,
    pos: torch.Tensor | None = None,
    cache_len: int = 0,
    rules: AxisRules | None = None,
) -> tuple[torch.Tensor, dict]:
    """Multi-head latent attention (src/repro/models/layers.py:511-620).

    Prefill runs the naive (decompressed) form: q/k width nope + rope, v
    width ``v_head_dim``, through the inline ``chunked_attention``, and
    emits the ``ckv`` (b, cache_len, kv_lora) and ``k_rope``
    (b, cache_len, rope) leaves zero-padded past s; train runs the same
    form and emits no cache.  Decode runs the
    absorbed form in f32 against those leaves: the new row lands at each
    row's ``pos`` in place, and key rows past ``pos`` are score-masked
    (``arange(S) <= pos``).  The value contraction multiplies masked rows
    by an exact 0, so the leaves' tails must be finite: the server leases
    them zeroed.
    """
    m = cfg.mla
    b, s, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, dv, c = (m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
                           m.kv_lora_rank)
    scale = (nope + rope_d) ** -0.5

    cq = rmsnorm(x @ p["wdq"], p["q_norm"])
    q = (cq @ p["wuq"]).reshape(b, s, H, nope + rope_d).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv_full = x @ p["wdkv"]  # (b, s, kv_lora + rope)
    c_kv = rmsnorm(ckv_full[..., :c], p["kv_norm"])
    k_rope = ckv_full[..., c:][:, None]  # (b, 1, s, rope)
    cos, sin = _rope_at(positions, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)

    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        ckv_c, kr_c = cache["ckv"], cache["k_rope"]
        _write_rows(ckv_c, c_kv[:, 0], pos, 1)
        _write_rows(kr_c, k_rope[:, 0, 0], pos, 1)
        # score_h(t) = (W_uk_h^T q_nope_h) . c_t + q_rope_h . kr_t
        wuk = p["wuk"].reshape(c, H, nope).float()
        q_abs = torch.einsum("bhqn,chn->bhqc", q_nope.float(), wuk)
        ckv_f = ckv_c.float()
        sc = (torch.einsum("bhqc,bkc->bhqk", q_abs, ckv_f)
              + torch.einsum("bhqr,bkr->bhqk", q_rope.float(),
                             kr_c.float())) * scale
        S = ckv_c.shape[1]
        mask = torch.arange(S, device=x.device)[None] <= pos[:, None]
        sc = torch.where(mask[:, None, None], sc, -1e30)
        pr = torch.softmax(sc, dim=-1)
        out_c = torch.einsum("bhqk,bkc->bhqc", pr, ckv_f)
        wuv = p["wuv"].reshape(c, H, dv).float()
        out = torch.einsum("bhqc,chv->bhqv", out_c, wuv).to(x.dtype)
        new_cache = cache
    elif mode in ("prefill", "train"):
        k_nope = (c_kv @ p["wuk"]).reshape(b, s, H, nope).transpose(1, 2)
        v = (c_kv @ p["wuv"]).reshape(b, s, H, dv).transpose(1, 2)
        qh = torch.cat([q_nope, q_rope], dim=-1)
        kh = torch.cat([k_nope, k_rope.expand(b, H, s, rope_d)], dim=-1)
        qh = constrain(qh, rules, "batch", "heads_act", None, None)
        out = chunked_attention(qh, kh, v, causal=True, chunk=ATTN_CHUNK,
                                rules=rules)  # prefill too: C20, as above
        new_cache = None
        if mode == "prefill":
            pad = cache_len - s
            new_cache = {
                "ckv": _pad_rows(c_kv, pad),
                "k_rope": _pad_rows(k_rope[:, 0], pad),
            }
    else:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    y = _merge_heads(out, None if mode == "decode" else rules) @ p["wo"]
    return y, new_cache


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM (falcon-mamba, jamba)
# ---------------------------------------------------------------------------


def _ssm_chunk_scan(
    a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The linear recurrence h_t = a_t * h_{t-1} + bx_t over one chunk.

    a, bx: (b, L, di, ds) float32; h0: (b, di, ds).  Returns ``(h_all,
    h_last)``.  A log-depth doubling scan over the chunk axis with the
    reference's associative combine ``(a_l a_r, b_l a_r + b_r)``
    (``jax.lax.associative_scan``, src/repro/models/layers.py:628-645):
    ceil(log2 L) steps, each combining every position with the one
    ``off`` before it.  Products of the decays stay within one chunk, so
    none underflows the way a ``cumprod`` closed form does.
    """
    L = a.shape[1]
    off = 1
    while off < L:
        bx = torch.cat([bx[:, :off], bx[:, :-off] * a[:, off:] + bx[:, off:]],
                       dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    h_all = a * h0[:, None] + bx
    return h_all, h_all[:, -1]


def _conv_seq(x_in: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The causal depthwise conv over a sequence and its SiLU: x_in (b, s,
    c), w (d_conv, c), bias (c,) -> (b, s, c) in x_in's dtype.  Each
    channel is a group of its own, so a shard of the channels needs only
    its own columns of ``w`` and ``bias``."""
    dc, c = w.shape
    xt = F.pad(x_in.float().transpose(1, 2), (dc - 1, 0))
    xc = F.conv1d(xt, w.float().t()[:, None, :], groups=c)
    return F.silu(xc.transpose(1, 2) + bias).to(x_in.dtype)


def _conv_step(state: torch.Tensor, x_in: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode token's conv: the window of ``state`` (b, d_conv - 1, c)
    and x_in (b, 1, c) -> (the SiLU'd output (b, 1, c) float32, the next
    state)."""
    window = torch.cat([state, x_in], dim=1)  # (b, dc, c)
    xc = torch.einsum("bkd,kd->bd", window.float(), w.float()) + bias
    return F.silu(xc)[:, None], window[:, 1:]


def _scan_step(h0, dt, xcf, B, C, A, D, z):
    """One decode token's selective-scan step from the state h0 (b, c, ds),
    gated by z: ``(y (b, 1, c) in z's dtype, the next state)``."""
    a = torch.exp(dt[:, 0, :, None] * A)
    bx = (dt[:, 0] * xcf[:, 0])[..., None] * B[:, 0][:, None, :]
    h = a * h0 + bx
    y = (torch.einsum("bds,bs->bd", h, C[:, 0]) + D * xcf[:, 0])[:, None]
    return (y * F.silu(z.float())).to(z.dtype), h


def _scan_seq(dt, xcf, B, C, A, D, z, *, chunk: int, train: bool,
              last: torch.Tensor | None):
    """The selective scan over a sequence in chunks of ``chunk`` rows from
    a zero state, gated by z: ``(y (b, s, c) in z's dtype, the state after
    the last row)``.  With ``last`` (a prefill) ``dt`` is 0 past it, so
    the pad rows leave the state as it is (C11); ``train`` checkpoints
    each chunk."""
    b, s, c = dt.shape
    if last is not None:
        real = torch.arange(s, device=dt.device) <= last.reshape(())
        dt = torch.where(real[None, :, None], dt, 0.0)

    def chunk_scan(h0, dt_c, x_c, B_c, C_c):
        a = torch.exp(dt_c[..., None] * A)  # (b, L, c, ds)
        bx = (dt_c * x_c)[..., None] * B_c[:, :, None, :]
        h_all, h_last = _ssm_chunk_scan(a, bx, h0)
        return torch.einsum("blds,bls->bld", h_all, C_c), h_last

    h = torch.zeros((b, c, A.shape[1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for c0 in range(0, s, chunk):
        cs = slice(c0, c0 + chunk)
        args = (h, dt[:, cs], xcf[:, cs], B[:, cs], C[:, cs])
        if train:
            # Keep only the chunk's inputs; its (b, L, c, ds) scan is
            # recomputed in the backward pass.
            y_c, h = checkpoint(chunk_scan, *args, use_reentrant=False)
        else:
            y_c, h = chunk_scan(*args)
        ys.append(y_c)
    y = torch.cat(ys, dim=1) + D * xcf
    return (y * F.silu(z.float())).to(z.dtype), h


def _in_proj_halves(w: torch.Tensor, rules: AxisRules | None):
    """``in_proj``'s x and z column halves, each laid out on
    ``ssm_inner`` as the whole is: gathered over the axes that split the
    columns, cut in two, each half cut again to this rank's columns.  It
    moves at most (d_model, 2 d_inner) of weights a rank, where slicing
    the product would gather (b, s, 2 d_inner) of activations."""
    from torch.distributed.tensor import Replicate, Shard

    di = w.shape[1] // 2
    whole = w.redistribute(w.device_mesh, [
        Replicate() if isinstance(q, Shard) and q.dim == 1 else q
        for q in w.placements])
    return tuple(constrain(h, rules, "embed", "ssm_inner")
                 for h in (whole[:, :di], whole[:, di:]))


def mamba_forward(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,
    cache: dict | None = None,
    last: torch.Tensor | None = None,
    rules: AxisRules | None = None,
) -> tuple[torch.Tensor, dict]:
    """Mamba-1 (src/repro/models/layers.py:648-758): in_proj -> causal
    depthwise conv -> selective scan -> gate.

    Prefill scans chunks of ``cfg.scan_chunk`` in a Python loop and emits
    the ``conv`` (b, d_conv - 1, d_inner) and ``ssm`` (b, d_inner, d_state,
    float32) state of row ``last``, the last real prompt token (a (1,)
    integer tensor, or None for the last row): ``dt`` is 0 past it, so
    ``a = 1`` and ``bx = 0`` there and the state passes the bucket pad
    unchanged, and the conv state is input rows last - d_conv + 2 ..
    last, zero-filled before row 0.  Both are tensor indexing, so a
    captured prefill replayed at another ``last`` leaves that row's state.
    Decode takes exactly one token and updates ``conv`` and ``ssm`` in
    place.  Train scans every row, checkpoints each chunk and emits no
    state.

    Over DTensors each rank keeps its own ``ssm_inner`` channels from the
    in_proj to the out_proj, as GSPMD partitions the reference's grouped
    conv (ROADMAP C21): the conv and the scan, each channel independent
    of the others, run on the local shards (:func:`on_local_shards`);
    only the x_proj's (b, s, dt_rank + 2 d_state) partial sum is reduced
    between them, and the out_proj leaves a partial for the caller.
    Outside decode the x and z halves come from in_proj's two column
    halves (:func:`_in_proj_halves`); a decode's one row gathers its
    product instead, the smaller of the two.
    """
    ssm = cfg.ssm
    b, s, d = x.shape
    di, ds, dc = ssm.d_inner, ssm.d_state, ssm.d_conv
    dtr = ssm.dt_rank or d // 16
    dev = x.device

    if mode != "decode" and is_dtensor(p["in_proj"]):
        w_x, w_z = _in_proj_halves(p["in_proj"], rules)
        x_in, z = x @ w_x, x @ w_z
    else:
        # A partial sum over the width's axes (FSDP) is reduced on the
        # rank's columns before they are gathered.
        xz = constrain(constrain(x @ p["in_proj"], rules, "batch", None,
                                 "ssm_inner"), rules, "batch", None, None)
        x_in, z = xz[..., :di], xz[..., di:]
    x_in = constrain(x_in, rules, "batch", None, "ssm_inner")
    z = constrain(z, rules, "batch", None, "ssm_inner")
    # The layouts of the channel-sharded (b, s, d_inner) activations and
    # of the (b, d_inner, d_state) state (unused on plain tensors).
    lay = lay_h = None
    if is_dtensor(x_in):
        from torch.distributed.tensor import Shard

        lay = x_in.placements
        lay_h = tuple(Shard(1) if q == Shard(2) else q for q in lay)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        if s != 1:
            # The conv window below holds exactly one new token; with s > 1
            # it would write a mis-sized conv state back into the cache.
            raise ValueError(
                "mamba_forward(mode='decode') consumes one token per step; "
                f"got s={s}. Feed multi-token input through mode='prefill' "
                "(which rebuilds the conv state from the tail) instead."
            )
        # float32 (b, 1, di) as the reference's
        xc, new_conv = on_local_shards(
            _conv_step, (lay, lay), cache["conv"], x_in, p["conv_w"],
            p["conv_b"])
    elif mode in ("prefill", "train"):
        xc = on_local_shards(_conv_seq, (lay,), x_in, p["conv_w"],
                             p["conv_b"])
        if mode == "prefill":
            if last is None:
                last = torch.full((1,), s - 1, dtype=torch.long, device=dev)
            idx = (last.reshape(()) - (dc - 2)
                   + torch.arange(dc - 1, device=dev))
            rows = x_in.index_select(1, idx.clamp(min=0))
            new_conv = torch.where((idx >= 0)[None, :, None], rows, 0)
    else:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")

    # (b, s, dtr + 2*ds), a partial sum over the channel shards: reduced.
    proj = constrain(xc.to(x.dtype) @ p["x_proj"], rules, "batch", None,
                     None)
    dt_r = proj[..., :dtr]
    B = proj[..., dtr:dtr + ds].float()
    C = proj[..., dtr + ds:].float()
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"])  # (b, s, di)
    dt = constrain(dt, rules, "batch", None, "ssm_inner")
    A = -torch.exp(p["A_log"].float())  # (di, ds)
    xcf = xc.float()

    if mode == "decode":
        y, h = on_local_shards(_scan_step, (lay, lay_h), cache["ssm"], dt,
                               xcf, B, C, A, p["D"], z)
        cache["ssm"].copy_(h)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        scan = functools.partial(
            _scan_seq, chunk=min(cfg.scan_chunk, s), train=mode == "train",
            last=last if mode == "prefill" else None)
        y, h = on_local_shards(scan, (lay, lay_h), dt, xcf, B, C, A,
                               p["D"], z)
        new_cache = {"conv": new_conv, "ssm": h} if mode == "prefill" else None
    return y @ p["out_proj"], new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _glu_act(
    cfg: ModelConfig, h: torch.Tensor, g: torch.Tensor | None
) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(g) * h
    if cfg.act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(h, approximate="tanh")


def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                rules: AxisRules | None = None) -> torch.Tensor:
    h = x @ p["w_in"]
    g = x @ p["w_gate"] if "w_gate" in p else None
    h = constrain(_glu_act(cfg, h, g), rules, "batch", None, "ff")
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# Lazy handle chain: whole-block prefill with zero boundary copies
# ---------------------------------------------------------------------------
# Engine-served block forward where every dispatch output stays a bucket-
# shaped LazyBucket and the next dispatch consumes the buffer directly
# (DESIGN.md §8).  The non-engine glue between dispatches (norms, rope,
# residual adds, head splits) runs row-locally on the raw buffers via
# lazy_map/LazyBucket.map, so nothing forces a realize inside a block.
# Single-card serving path (launch/serve.py prefill="chained"): handles are
# eager-only; the eager per-op reference (``lazy=False``) runs the
# identical dispatch sequence on plain tensors and is the bit-identity
# baseline.  Every buffer handed to a kernel is dense: head splits copy
# (``_split_heads``), head merges copy (``_merge_heads`` reshapes a
# transpose), and the gemm's (b*s, d) row view of a dense (b, s, d) buffer
# is a view.


def lazy_matmul(engine, x, w, *, lazy: bool = True):
    """``x @ w`` through the engine's gemm with ``x`` (b, s, d) either a
    plain tensor or a fully-valid seq-axis LazyBucket (extent == buffer
    seq).  A handle flattens to a (b*s, d) row handle and forwards
    bucket-to-bucket; the output re-wraps on the seq axis, clamped back to
    the chain width if the gemm bucket outgrew it (one counted slice)."""
    if (
        lazy and isinstance(x, LazyBucket) and x.axis == 1
        and x.extent == x.buffer.shape[1]
    ):
        b, s, d = x.buffer.shape
        flat = x.rewrap(x.buffer.reshape(b * s, d), extent=b * s, axis=0)
        out = engine.dispatch("gemm", flat, w, lazy=True)
        if isinstance(out, LazyBucket):
            out = out.clamp(b * s)
            return x.rewrap(out.buffer.reshape(b, s, -1))
        return out.reshape(b, s, -1)  # the engine returned a plain tensor
    if isinstance(x, LazyBucket):
        x = x.realize()
    b, s, d = x.shape
    out = engine.dispatch("gemm", x.reshape(b * s, d), w)
    return out.reshape(b, s, -1)


def attn_forward_lazy(
    engine,
    p: dict,
    x,
    cfg: ModelConfig,
    spec: LayerSpec,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    lazy: bool = True,
):
    """Prefill GQA attention as a handle chain: q/k/v projections,
    attention and the output projection all forward bucket-to-bucket.

    ``positions`` must cover the BUFFER seq width (rope is row-local, so
    pad rows get real rotations applied to garbage -- confined).  Returns
    ``(y, {"k": k, "v": v})`` where k/v are the post-rope head-split
    projections -- (b, KV, s, hd) handles on the seq axis, which serving
    writes into the kv cache.
    """
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads

    q = lazy_matmul(engine, x, p["wq"], lazy=lazy)
    k = lazy_matmul(engine, x, p["wk"], lazy=lazy)
    v = lazy_matmul(engine, x, p["wv"], lazy=lazy)

    def split(t, n):
        if isinstance(t, LazyBucket):
            return t.rewrap(_split_heads(t.buffer, n), axis=2)
        return _split_heads(t, n)

    q, k, v = split(q, H), split(k, KV), split(v, KV)

    if cfg.use_rope:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        cos, sin = cos[None, None], sin[None, None]  # (1, 1, s, hd/2)

        def rope(t):
            return apply_rope(t, cos, sin)

        q = q.map(rope) if isinstance(q, LazyBucket) else rope(q)
        k = k.map(rope) if isinstance(k, LazyBucket) else rope(k)

    out = engine.dispatch(
        "attention", q, k, v, causal=causal, window=spec.window,
        softcap=cfg.attn_softcap, lazy=lazy,
    )
    sp = (x.buffer if isinstance(x, LazyBucket) else x).shape[1]
    if isinstance(out, LazyBucket):
        out = out.clamp(sp)
        merged = out.rewrap(_merge_heads(out.buffer), axis=1)
    else:
        merged = _merge_heads(out)
    y = lazy_matmul(engine, merged, p["wo"], lazy=lazy)
    return y, {"k": k, "v": v}


def mlp_forward_lazy(engine, p: dict, x, cfg: ModelConfig, *,
                     lazy: bool = True):
    """Dense MLP as a handle chain (activation via lazy_map, row-local)."""
    h = lazy_matmul(engine, x, p["w_in"], lazy=lazy)
    if "w_gate" in p:
        g = lazy_matmul(engine, x, p["w_gate"], lazy=lazy)
        h = lazy_map(lambda a, b: _glu_act(cfg, a, b), h, g)
    else:
        h = lazy_map(lambda a: _glu_act(cfg, a, None), h)
    return lazy_matmul(engine, h, p["w_out"], lazy=lazy)


def block_forward_lazy(
    engine,
    p: dict,
    x,
    cfg: ModelConfig,
    spec: LayerSpec,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    lazy: bool = True,
):
    """One transformer block (attn mixer + dense/none MLP) as a handle
    chain: the attention -> projection -> MLP sequence passes LazyBuckets
    across every engine boundary; norms and residual adds ride lazy_map.
    Returns ``(x, kv)`` with kv the layer's k/v handles for the cache."""
    if not (spec.mixer == "attn" and spec.mlp in ("dense", "none")
            and not spec.cross_attn):
        raise ValueError("the lazy chain serves plain attn blocks only")
    h = lazy_map(lambda t: norm(t, p["norm_mixer"], cfg), x)
    y, kv = attn_forward_lazy(
        engine, p["attn"], h, cfg, spec,
        positions=positions, causal=causal, lazy=lazy,
    )
    x = lazy_map(torch.add, x, y)
    if spec.mlp != "none":
        h = lazy_map(lambda t: norm(t, p["norm_mlp"], cfg), x)
        y = mlp_forward_lazy(engine, p["mlp"], h, cfg, lazy=lazy)
        x = lazy_map(torch.add, x, y)
    return x, kv


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Rows per expert slab for a routing group of ``s`` tokens:
    ``max(1, ceil(s * top_k * capacity_factor / num_experts))``."""
    m = cfg.moe
    return max(1, int(math.ceil(s * m.top_k * m.capacity_factor
                                / m.num_experts)))


def route(
    p: dict, x: torch.Tensor, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing in f32: ``(probs (b, s, E), topw (b, s, k) renormalised
    to sum 1, topi (b, s, k))``, choices in descending probability."""
    probs = torch.softmax(
        torch.einsum("gtd,de->gte", x.float(), p["router"].float()), dim=-1
    )
    topw, topi = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def _expert_ffn(
    p: dict, buf: torch.Tensor, cfg: ModelConfig, counts: torch.Tensor,
    engine, rules: AxisRules | None = None,
) -> torch.Tensor:
    """buf: (g, E, C, d) -> (g, E, C, d) through the per-expert FFNs.

    ``counts`` (g, E) int32 is each expert slab's TRUE row count; rows past
    it are routing pad (zero-filled by :func:`moe_forward`).  With an
    ``engine`` the three projections are three ``grouped_gemm``
    dispatches, each ONE launch for all g*E slabs with the capacity as the
    bucketed extent and the counts riding in as the device-side extent
    vector.  Without one, inline einsums.
    """
    if engine is not None:
        g, E, C, d = buf.shape
        # Expert-major group layout (g, E, C, d) -> (E*g, C, d): the r = g
        # consecutive groups of each expert share one weight-stack entry
        # (the grouped_gemm contract: weight index = group // r).
        xs = buf.transpose(0, 1).reshape(E * g, C, d)
        cnt = counts.transpose(0, 1).reshape(E * g)
        h = engine.dispatch("grouped_gemm", xs, p["w_in"], cnt)
        gate = (
            engine.dispatch("grouped_gemm", xs, p["w_gate"], cnt)
            if "w_gate" in p else None
        )
        h = _glu_act(cfg, h, gate)
        out = engine.dispatch("grouped_gemm", h, p["w_out"], cnt)
        return out.reshape(E, g, C, -1).transpose(0, 1)

    # Over DTensors an FSDP-sharded expert stack is gathered on its
    # "embed" dim first: DTensor's einsum fails to take the stack sharded
    # on both the expert and the contracted or output width.  A prefill's
    # and a train step's slabs outweigh it; a decode's keep the stack
    # sharded (:func:`_expert_ffn_local`).
    w = {k: constrain(p[k], rules, "expert", None, None)
         for k in ("w_in", "w_gate", "w_out") if k in p}
    h = torch.einsum("gecd,edf->gecf", buf, w["w_in"])
    gate = (
        torch.einsum("gecd,edf->gecf", buf, w["w_gate"])
        if "w_gate" in w else None
    )
    h = _glu_act(cfg, h, gate)
    return torch.einsum("gecf,efd->gecd", h, w["w_out"])


def _embed_sharded(w: torch.Tensor) -> bool:
    """Whether an expert stack is a DTensor sharded on its ``embed`` width
    (dim 1 of w_in: FSDP)."""
    from torch.distributed.tensor import Shard

    return is_dtensor(w) and any(isinstance(q, Shard) and q.dim == 1
                                 for q in w.placements)


def _expert_ffn_local(p: dict, buf: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """:func:`_expert_ffn` of a decode (no gradient) over DTensor stacks
    sharded on the experts and, FSDP, on ``embed``: the stacks stay as
    they lie, as the reference leaves the decode's slabs unpinned and
    GSPMD all-reduces the activations instead of gathering the weights
    (src/repro/models/layers.py:1054-1064; ROADMAP C22).

    ``buf`` is laid out as the stacks are, the experts and the width on
    their axes (the batch gathered where it shared one with the width),
    and each rank runs its own experts on its own ``embed`` slice as
    plain tensors.  The partial h and gate are reduced over the width's
    axes before the GLU, which is not linear; the output keeps the
    rank's slice of the width: (g, E, C, d) laid out as ``buf``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = p["w_in"].device_mesh
    # The buf dim of each sharded stack dim: (E, d, f) -> (1, 3, -).
    lay = [Shard({0: 1, 1: 3}[q.dim]) if isinstance(q, Shard) else Replicate()
           for q in p["w_in"].placements]
    part = [Partial() if q == Shard(3) else q for q in lay]
    whole = [Replicate() if q == Shard(3) else q for q in lay]
    xs = buf.redistribute(mesh, lay).to_local()

    def project(w):
        h = torch.einsum("gecd,edf->gecf", xs, w.to_local())
        return DTensor.from_local(h, mesh, part, run_check=False) \
            .redistribute(mesh, whole).to_local()

    h = project(p["w_in"])
    gate = project(p["w_gate"]) if "w_gate" in p else None
    out = torch.einsum("gecf,efd->gecd", _glu_act(cfg, h, gate),
                       p["w_out"].to_local())
    return DTensor.from_local(out, mesh, lay, run_check=False)


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value as a plain tensor on every rank (a plain
    tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def moe_forward(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str = "prefill",
    rules: AxisRules | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routed MoE with sort-based, capacity-bounded dispatch.

    Each batch row is a routing group.  Every expert has capacity
    ``C = moe_capacity(cfg, s)`` rows and admits its
    first C assignments in flat (token, choice) order (a stable argsort
    keeps that order); a dropped assignment contributes exactly 0 to its
    token's combine, with no renormalisation over the kept experts.  The
    dispatch is gather-only, as in the reference.  Returns ``(y, aux,
    dropped_frac, topi)``: the Switch load-balance loss, the fraction of
    assignments the capacity bound dropped, and the (b, s, k) expert
    choices — every statistic a device tensor, never read on the host.
    The experts dispatch through an installed session's engine except in
    train mode, which keeps them on the einsums autograd differentiates.
    """
    m = cfg.moe
    b, s, d = x.shape
    E, k = m.num_experts, m.top_k
    C = moe_capacity(cfg, s)
    dev = x.device
    probs, topw, topi = route(p, x, cfg)
    # The routing's index arithmetic (one_hot, argsort, searchsorted,
    # integer gathers) has no DTensor sharding rule: over DTensors it runs
    # on a replicated plain copy of the choices.
    choice = _replicated(topi)

    # Aux loss (Switch): E * sum_e f_e * P_e over all tokens.
    f_e = F.one_hot(choice[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(f_e * probs.mean(dim=(0, 1)))

    S = s * k
    flat_e = choice.reshape(b, S)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # sorted pos -> flat
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=dev)
    # Start of each expert's segment in the sorted order.
    first = torch.searchsorted(
        sorted_e, experts.expand(b, E).contiguous(), right=False
    )                                                     # (b, E)
    # Forward map: slot (e, c) <- sorted position first[e] + c.
    p_grid = first[:, :, None] + torch.arange(C, device=dev)  # (b, E, C)
    p_clip = p_grid.clamp(max=S - 1).reshape(b, E * C)
    e_at_p = torch.gather(sorted_e, 1, p_clip).reshape(b, E, C)
    valid = (p_grid < S) & (e_at_p == experts[None, :, None])
    token_idx = torch.gather(order, 1, p_clip) // k       # (b, E*C)
    buf = torch.gather(x, 1, token_idx[..., None].expand(b, E * C, d))
    buf = torch.where(valid.reshape(b, E * C, 1), buf, 0).reshape(b, E, C, d)
    # ``valid`` is a prefix of each slab, so its sum is the slab's extent.
    counts = valid.sum(dim=-1, dtype=torch.int32)         # (b, E)

    if s > 1:
        # The expert slabs pinned to (batch, expert), so the FFN einsums
        # partition over the EP axis (reference :1054-1065).
        buf = constrain(buf, rules, "batch", "expert", None, None)
    engine = session.installed_engine() if mode != "train" else None
    if (s == 1 and mode != "train" and engine is None
            and _embed_sharded(p["w_in"])):
        out_buf = _expert_ffn_local(p, buf, cfg)
    else:
        out_buf = _expert_ffn(p, buf, cfg, counts, engine, rules)
    if s > 1:
        out_buf = constrain(out_buf, rules, "batch", "expert", None, None)
    out_flat = out_buf.reshape(b, E * C, d)

    # Return map: flat position f sits at sorted position inv[f], in slot
    # (flat_e[f], inv[f] - first[flat_e[f]]).
    inv = torch.argsort(order, dim=-1)
    pos_in_e = inv - torch.gather(first, 1, flat_e)
    kept = pos_in_e < C
    dropped_frac = 1.0 - kept.float().mean()
    out_idx = (flat_e * C + pos_in_e).clamp(max=E * C - 1)
    y_tok = torch.gather(out_flat, 1, out_idx[..., None].expand(b, S, d))
    y_tok = torch.where(kept[..., None], y_tok, 0).float()
    y_tok = y_tok * topw.reshape(b, S)[..., None]
    y = y_tok.reshape(b, s, k, d).sum(dim=2).to(x.dtype)

    if m.num_shared:
        h = x @ p["shared_in"]
        gate = x @ p["shared_gate"] if "shared_gate" in p else None
        y = y + _glu_act(cfg, h, gate) @ p["shared_out"]
    return y, aux, dropped_frac, topi
