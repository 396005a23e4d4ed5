"""Dynamic-shape serving driver (counterpart of src/repro/launch/serve.py).

Requests arrive with arbitrary batch sizes and prompt lengths.  The server
quantizes both through the vortex engine session it owns:

  * the sequence dim is bucketed by the engine's own selection machinery —
    ``CompiledOp.bucket`` over the model's GEMM signature, the same lattice
    breakpoints the runtime selector bisects;
  * the request batch dim is pow2-bucketed (``vortex.pow2_bucket``).

Each request is one eager prefill forward at its (batch-bucket,
seq-bucket) shape, then one decode step per token, all under
``engine.use()`` so prefill attention and every decode token's attention
dispatch through the engine — on the card, through the hand-written
kernels.  On the card a decode step is ONE replay of a CUDA graph captured
per (form, batch bucket, kv bucket, cache) (launch/graphs.py), the
counterpart of the reference's AOT decode programs; ``graphs=False``, or
the CPU, runs the same step eagerly, op by op.  The KV cache lives in
kv-BUCKET-shaped buffers (the decode-attention workload's own bucket
set), each token's K/V row is
written into it in place, and rows past ``pos`` are dead weight the kv_len
mask never reads.  When ``pos`` outgrows the bucket the cache is copied
once into the next bucket's buffers (amortized doubling).  With graphs on,
the prefill writes its cache into leaves leased from the kv pool, so a
request of a shape served before decodes against the same buffers and
replays the graphs captured for them.  ``decode_stats`` (a DispatchStats)
counts one step per token, growth copies and pad fallbacks (always 0).  An MoE model's expert FFNs dispatch through the
grouped-GEMM workload, with the capacity (set by the PADDED prompt length)
as its dynamic extent; ``mean_dropped_frac`` reports the capacity drops.

Unlike the reference, the first generated token is the argmax at the last
REAL prompt position (s - 1), not at the last padded position of the
sequence bucket.

Continuous batching (launch/scheduler.py) drives the same server through
:meth:`VortexServer.prefill` (one request's prefill, its cache leased) and
:meth:`VortexServer.decode_vec` (one decode step for rows at mixed
progress: ``pos`` a (bp,) device vector), the counterparts of the
reference's ``_prefill_exec_for`` and ``_decode_exec_vec_for``.  Its
failure domains use the typed errors here (:class:`RequestError`,
:class:`QueueFullError`, :class:`DeadlineExceeded`), and the pool's
``lease`` is a fault-injection site (runtime/faults.py ``pool_lease``).

``python -m repro_torch.launch.serve --arch paper-gpt2-124m --requests 8``
``python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --requests 8``
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core.engine import DispatchStats
from repro_torch.core.workloads import (
    AttentionWorkload,
    DecodeAttentionWorkload,
    GemmWorkload,
    GroupedGemmWorkload,
)
from repro_torch.core.hardware import get_hardware
from repro_torch.launch.graphs import DecodeGraphs
from repro_torch.models.layers import moe_capacity
from repro_torch.models.model import abstract_cache, decode_step, prefill_step
from repro_torch.models.params import init_params
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.runtime import faults
from repro_torch.vortex import CompiledOp, Engine, EngineConfig, pow2_bucket

__all__ = [
    "VortexServer",
    "Request",
    "KVBucketPool",
    "RequestError",
    "QueueFullError",
    "DeadlineExceeded",
    "CacheOverflowError",
]


class CacheOverflowError(ValueError):
    """The request cannot fit ``max_cache`` even after growth — refused up
    front, before any prefill work, by both admission paths: the serial
    ``generate()`` and the scheduler's ``submit()``."""


class QueueFullError(RuntimeError):
    """``submit()`` refused: the scheduler's bounded admission queue
    (``max_queue``) is at capacity — back-pressure, not failure; retry
    after a drain."""


class RequestError(RuntimeError):
    """A typed per-request failure: the scheduler's ``drain()`` returns it
    (in place of the token array) for a request whose admission, cache
    growth or decode raised — the step loop itself goes on.  ``stage``
    names the failure domain (``admit`` / ``grow`` / ``decode`` /
    ``deadline``)."""

    def __init__(self, request_id: int, stage: str, message: str):
        self.request_id = request_id
        self.stage = stage
        super().__init__(
            f"request {request_id} failed during {stage}: {message}"
        )


class DeadlineExceeded(RequestError):
    """A request's wall-clock ``deadline_s`` expired before completion;
    its rows retire at once and the slots are reused next step."""

    def __init__(self, request_id: int, deadline_s: float):
        self.deadline_s = deadline_s
        super().__init__(
            request_id, "deadline",
            f"deadline_s={deadline_s} expired before completion",
        )


@dataclasses.dataclass
class Request:
    tokens: np.ndarray  # (batch, prompt_len)
    max_new: int = 8
    # Early-stop token: a row that emits it retires, its remaining output
    # positions filled with the stop token (scheduler path; the serial
    # ``generate()`` always runs to max_new).
    stop: int | None = None
    # Assigned by the scheduler's admission queue so responses can be
    # matched to submissions; ``generate()`` never reads it.
    request_id: int | None = None
    # Wall-clock budget from ``submit()`` (scheduler path only): once it
    # expires the request resolves to ``DeadlineExceeded``.  None = none.
    deadline_s: float | None = None


class KVBucketPool:
    """Shared pool of kv-bucket cache buffers, leased per request.

    Released buffers PARK keyed by (shape, dtype, device) and are handed
    back AS-IS — stale bytes and all — on the next lease; that is safe
    because attention k/v leaves are only ever read through the
    kv_len-masked decode workload.  A leased buffer belongs to its request
    alone until the request releases it; the request never touches it
    afterwards, so the pool never hands out a buffer someone still reads
    (on the card, leases and releases are issued in stream order by the
    one serving thread).

    Every cache leaf in flight counts as one active lease
    (``leases_active``; high-water mark ``leases_peak``) whether it came
    from the free list or a fresh allocation — a non-zero
    ``leases_active`` at idle is a leak.

    A lease pops the most recently parked buffer of its key, so a set of
    leaves leased in order and released in REVERSE order comes back leaf
    for leaf on the next lease of the same shapes: the stable addresses a
    captured decode graph binds.  ``tag`` parts the parked buffers of one
    shape by owner (the scheduler's shared cache parks apart from
    per-request caches, whose lifetimes interleave with it).
    """

    # Parked buffers per key; beyond this the oldest are dropped.
    _MAX_PARKED = 16

    def __init__(self) -> None:
        self._free: dict[tuple, list[torch.Tensor]] = {}
        self._lock = threading.Lock()
        self.leases_active = 0
        self.leases_peak = 0
        self.lease_hits = 0
        self.lease_allocs = 0
        self.released = 0

    @staticmethod
    def _key(shape, dtype, device, tag: str = "") -> tuple:
        return (tuple(shape), dtype, str(device), tag)

    def lease(self, shape, dtype, device, tag: str = "") -> torch.Tensor:
        """One bucket-shaped buffer: a parked one when available (stale
        contents — read it through a kv_len mask), else fresh zeros."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("pool_lease")
        key = self._key(shape, dtype, device, tag)
        buf = None
        with self._lock:
            free = self._free.get(key)
            if free:
                buf = free.pop()
                self.lease_hits += 1
            else:
                self.lease_allocs += 1
            self.leases_active += 1
            self.leases_peak = max(self.leases_peak, self.leases_active)
        if buf is None:
            buf = torch.zeros(tuple(shape), dtype=dtype, device=device)
        return buf

    def adopt(self, n: int) -> None:
        """Register ``n`` buffers that entered circulation outside
        ``lease`` (with graphs off, the prefill step emits the initial
        cache leaves)."""
        with self._lock:
            self.leases_active += n
            self.leases_peak = max(self.leases_peak, self.leases_active)

    def release(self, leaf: torch.Tensor, tag: str = "") -> None:
        """Return a leased buffer to the pool (under the tag it was leased
        with)."""
        with self._lock:
            free = self._free.setdefault(
                self._key(leaf.shape, leaf.dtype, leaf.device, tag), []
            )
            free.append(leaf)
            if len(free) > self._MAX_PARKED:
                del free[0]
            self.leases_active -= 1
            self.released += 1

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "leases_active": self.leases_active,
                "leases_peak": self.leases_peak,
                "lease_hits": self.lease_hits,
                "lease_allocs": self.lease_allocs,
                "released": self.released,
            }


class VortexServer:
    """Batched LM serving with Vortex-bucketed dynamic shapes.

    The server owns (or is handed) an :class:`Engine` session; its
    sequence buckets are the engine's selection buckets.  By default it
    runs on the card with the H100 lattice and the hand-written kernels
    (``device="cuda"``, ``hardware="h100_sxm"``); ``device="cpu"`` runs the
    plain versions.  The engine scores only the hardware's default backend
    (tensor cores on the H100, the MXU on the TPU lattice), as the
    reference server does.  ``params`` (a tree from
    :func:`~repro_torch.models.params.params_from_numpy`) replaces the
    seeded init.

    ``graphs``: None (the default) replays one captured CUDA graph per
    decode step on the card and runs the step eagerly on the CPU;
    ``False`` runs the eager step on the card too, for comparison.  A
    capture or replay that fails raises: the eager step is never a
    fallback.  ``stats`` counts ``decode_graph_captures`` and
    ``decode_graph_replays`` beside the reference's bucket counters.
    """

    def __init__(
        self,
        cfg,
        *,
        max_cache: int = 512,
        seed: int = 0,
        engine: Engine | None = None,
        params: dict | None = None,
        device="cuda",
        hardware: str = "h100_sxm",
        impl: str | None = None,
        graphs: bool | None = None,
    ):
        self.cfg = cfg
        if engine is None:
            engine = Engine(EngineConfig(
                hardware=hardware,
                backends=(get_hardware(hardware).default_backend,),
                device=device, impl=impl,
            ))
        self.engine = engine
        dev = torch.device(engine.device)
        if dev.type == "cuda" and dev.index is None:
            # One spelling of the card for the kv pool's keys: leaves
            # report cuda:<index>.
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if params is None:
            # Drawn on the server's device, one leaf at a time.
            params = init_params(
                cfg, torch.Generator(self.device).manual_seed(seed),
                self.device,
            )
        self.params = params
        self.max_cache = max_cache
        # The token dim's bucket source: the model's GEMM signature
        # (N/K = d_model); the selector's M-buckets become our seq buckets.
        self._seq_op = CompiledOp(engine, engine.kernel_for(
            GemmWorkload(M=None, N=cfg.d_model, K=cfg.d_model)
        ))
        # The cache dim's bucket source: the decode-attention workload's kv
        # buckets (== the kv buckets prefill attention streams).
        self._decode_op = CompiledOp(engine, engine.kernel_for(
            DecodeAttentionWorkload(seq=None, head_dim=cfg.resolved_head_dim)
        ))
        self.kv_pool = KVBucketPool()
        # First use of a (batch, seq) / (batch, kv) bucket vs repeat use;
        # the mixed-progress decode (``decode_vec``) keys its own set, as
        # the reference caches its vector-pos programs apart.
        self._prefill_seen: set[tuple[int, int]] = set()
        self._decode_seen: set[tuple[int, int]] = set()
        self._decode_vec_seen: set[tuple[int, int]] = set()
        self.stats = {
            "prefill_buckets": 0, "bucket_hits": 0,
            "decode_buckets": 0, "decode_bucket_hits": 0,
            "decode_graph_captures": 0, "decode_graph_replays": 0,
        }
        if graphs is None:
            graphs = self.device.type == "cuda"
        self.graphs = DecodeGraphs(engine, self.device) if graphs else None
        # Per-token decode accounting: one step per token, zero pad
        # fallbacks, a stage copy only when the cache grows.
        self.decode_stats = DispatchStats()
        # MoE capacity drops: the sum of every forward's mean dropped_frac
        # (a device scalar, read only by mean_dropped_frac) and the count.
        self._dropped_sum = torch.zeros((), device=self.device)
        self._moe_forwards = 0

    # -- engine-owned bucketing ---------------------------------------------

    def seq_bucket(self, s: int) -> int:
        """The engine-selected padded size for a prompt length (capped by
        the cache length)."""
        return min(self._seq_op.bucket(s), self.max_cache)

    @staticmethod
    def batch_bucket(b: int) -> int:
        """Pow2 bucket for the request batch dim."""
        return pow2_bucket(b)

    def seq_buckets(self, m_max: int | None = None) -> list[int]:
        """Every sequence bucket this server can emit."""
        m_max = self.max_cache if m_max is None else min(m_max, self.max_cache)
        return sorted({min(b, self.max_cache)
                       for b in self._seq_op.buckets(m_max)})

    def kv_bucket(self, n: int) -> int:
        """The decode cache length covering ``n`` valid rows: the
        decode-attention workload's own kv bucket, capped by max_cache."""
        return min(self._decode_op.bucket(n), self.max_cache)

    def _grown_kv_bucket(self, kvb: int, needed: int) -> int:
        """The next cache length once ``needed`` rows outgrow ``kvb``:
        amortized doubling quantized to a kv bucket."""
        return self.kv_bucket(max(needed, 2 * kvb))

    def decode_buckets(
        self, *, m_max: int | None = None, max_new: int = 0
    ) -> list[int]:
        """Every cache length decode can run at for prompts up to
        ``m_max`` generating up to ``max_new`` tokens."""
        m_max = self.max_cache if m_max is None else min(m_max, self.max_cache)
        out: set[int] = set()
        for sp in self.seq_buckets(m_max):
            kvb = self.kv_bucket(sp)
            out.add(kvb)
            limit = min(sp + max(max_new, 0), self.max_cache)
            while kvb < limit:
                kvb = self._grown_kv_bucket(kvb, kvb + 1)
                out.add(kvb)
        return sorted(out)

    def _note(self, seen: set, key: tuple, first: str, hit: str) -> None:
        if key in seen:
            self.stats[hit] += 1
        else:
            seen.add(key)
            self.stats[first] += 1

    # -- cache leases -------------------------------------------------------

    @staticmethod
    def _cache_leaves(cache: dict):
        for entry in cache.values():
            yield from entry.values()

    def _tag(self, shared: bool) -> str:
        # With graphs on, the scheduler's shared cache parks apart (see
        # KVBucketPool); with graphs off the pool keys as the reference's.
        return "shared" if shared and self.graphs is not None else ""

    def adopt_cache(self, cache: dict) -> None:
        """Register a prefill-emitted cache's leaves as active leases."""
        self.kv_pool.adopt(sum(1 for _ in self._cache_leaves(cache)))

    def lease_cache(self, batch: int, cache_len: int, *,
                    shared: bool = False) -> dict:
        """A decode cache of kv-bucket leaves leased from the pool, one
        leaf at a time and settled on failure: a fault partway
        (``pool_lease`` injection, out of memory) must not strand the
        leaves already checked out.  Stale contents: every read goes
        through the kv_len mask."""
        spec = abstract_cache(self.cfg, batch, cache_len)
        tag = self._tag(shared)
        cache: dict = {}
        leased: list[torch.Tensor] = []
        try:
            for key, entry in spec.items():
                got = {}
                for name, leaf in entry.items():
                    buf = self.kv_pool.lease(leaf.shape, leaf.dtype,
                                             self.device, tag)
                    leased.append(buf)
                    got[name] = buf
                cache[key] = got
        except BaseException:
            for buf in reversed(leased):
                self.kv_pool.release(buf, tag)
            raise
        return cache

    def release_cache(self, cache: dict, *, shared: bool = False) -> None:
        """Return every cache leaf to the pool, in the reverse of the lease
        order, so the next lease of the same shapes gets the same leaves
        back in the same places."""
        tag = self._tag(shared)
        for leaf in reversed(list(self._cache_leaves(cache))):
            self.kv_pool.release(leaf, tag)

    def _grow_cache(self, cache: dict, new_len: int, *,
                    shared: bool = False) -> dict:
        """Copy the cache into ``new_len``-long leased bucket buffers (one
        in-place copy of the valid extent per leaf, only at bucket
        transitions), then release the outgrown leaves.  Two-phase: a
        failure mid-grow releases the partial new set and leaves ``cache``
        untouched for the caller's settling ``finally``."""
        tag = self._tag(shared)
        new_leases: list[torch.Tensor] = []
        out: dict = {}
        try:
            for key, entry in cache.items():
                grown = {}
                for name, leaf in entry.items():
                    shape = list(leaf.shape)
                    shape[3] = new_len
                    buf = self.kv_pool.lease(shape, leaf.dtype, leaf.device,
                                             tag)
                    new_leases.append(buf)
                    buf[:, :, :, :leaf.shape[3]].copy_(leaf)
                    grown[name] = buf
                out[key] = grown
        except BaseException:
            for buf in reversed(new_leases):
                self.kv_pool.release(buf, tag)
            raise
        n_old = sum(1 for _ in self._cache_leaves(cache))
        self.release_cache(cache, shared=shared)
        self.decode_stats.stage_copies += n_old
        return out

    # -- warmup -------------------------------------------------------------

    def warmup(
        self, *, max_batch: int = 1, m_max: int | None = None,
        max_new: int = 8, capture: bool = True,
    ) -> int:
        """Build, before traffic, every executable the requests up to
        ``max_batch``/``m_max``/``max_new`` can reach (and, on the card,
        the kernel library itself): prefill attention over the seq
        buckets, decode attention over the kv buckets and, for an MoE
        model, the grouped-GEMM capacity buckets that the seq buckets and
        decode (s = 1) imply, per batch bucket.  With graphs on and
        ``capture``, also capture the scalar-form decode graph of every
        reachable (batch bucket, kv bucket) (``generate()``'s), each
        against a cache leased from the pool and parked again, so that a
        later request of that shape leases the same leaves and replays it
        (a large model passes ``capture=False``: every parked cache stays
        allocated).  Returns the number of executables built."""
        cfg, eng = self.cfg, self.engine
        m_max = self.max_cache if m_max is None else min(m_max, self.max_cache)
        hd = cfg.resolved_head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads
        attn = {
            eng.kernel_for(AttentionWorkload(
                seq=None, head_dim=hd, causal=True, window=spec.window,
                softcap=cfg.attn_softcap,
            ))
            for spec in cfg.pattern
        }
        dec = {
            eng.kernel_for(DecodeAttentionWorkload(
                seq=None, head_dim=hd, causal=True, window=spec.window,
                softcap=cfg.attn_softcap,
            ))
            for spec in cfg.pattern
        }
        bps = [1]
        while bps[-1] < pow2_bucket(max_batch):
            bps.append(2 * bps[-1])
        grouped = set()
        c_max = 0
        if cfg.moe is not None:
            E, fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
            # Prefill runs at every seq bucket, decode at s = 1.
            c_max = max(moe_capacity(cfg, sp)
                        for sp in self.seq_buckets(m_max))
            grouped = {
                eng.kernel_for(GroupedGemmWorkload(C=None, G=E * bp, E=E,
                                                   N=n, K=k))
                for bp in bps
                for n, k in ((fe, cfg.d_model), (cfg.d_model, fe))
            }
        m_kv = max(self.decode_buckets(m_max=m_max, max_new=max_new))
        # Only the shapes matter (exec_key): meta tensors allocate nothing.
        def meta(*shape):
            return torch.empty(shape, device="meta")

        def built() -> int:
            return sum(k.cache_info["entries"] for k in attn | dec | grouped)

        before = built()
        for bp in bps:
            for k in attn:
                k.precompile(m_max, meta(bp, H, 1, hd), meta(bp, KV, 1, hd),
                             meta(bp, KV, 1, hd))
            for k in dec:
                k.precompile(m_kv, meta(bp, H, 1, hd), meta(bp, KV, 1, hd),
                             meta(bp, KV, 1, hd), 1)
        for k in grouped:
            k.precompile(c_max)
        if capture and self.graphs is not None:
            for bp in bps:
                tokens = torch.zeros((bp, 1), dtype=torch.int64,
                                     device=self.device)
                for kvb in self.decode_buckets(m_max=m_max, max_new=max_new):
                    cache = self.lease_cache(bp, kvb)
                    try:
                        if self.graphs.get(self._graph_key(cache, bp, 0)) \
                                is None:
                            self._capture(cache, tokens, 0)
                    finally:
                        self.release_cache(cache)
        return built() - before

    def mean_dropped_frac(self) -> float:
        """Mean MoE ``dropped_frac`` over every forward served so far (0.0
        for a dense model); one device-to-host read."""
        if not self._moe_forwards:
            return 0.0
        return float(self._dropped_sum.item()) / self._moe_forwards

    # -- introspection ------------------------------------------------------

    def engine_dispatch_stats(self) -> dict[str, dict]:
        """Per-kind hot-path accounting from the engine session PLUS the
        server's per-token decode accounting under ``decode_step``, the kv
        pool's lease ledger under ``kv_pool`` and the engine's background
        calibration counters under ``calibration``."""
        keep = (
            "calls", "launches", "aligned_calls", "unaligned_calls",
            "stage_copies", "unstage_copies", "padded_calls",
            "traced_calls", "forwarded", "realize_slices",
            "fallbacks", "quarantined",
        )
        estats = self.engine.stats()
        out = {
            kind: {k: s[k] for k in keep}
            for kind, s in estats.items()
            if kind != "calibration"  # engine-level section, not a kind
        }
        d = self.decode_stats.as_dict()
        out["decode_step"] = {k: d[k] for k in keep}
        out["kv_pool"] = self.kv_pool.stats()
        out["calibration"] = estats["calibration"]
        return out

    # -- serving ------------------------------------------------------------

    def _note_moe(self, dropped_frac: torch.Tensor) -> None:
        if self.cfg.moe is not None:
            self._dropped_sum += dropped_frac
            self._moe_forwards += 1

    def check_fits(self, req: Request, where: str = "") -> None:
        """Raise :class:`CacheOverflowError` when ``req`` cannot fit
        ``max_cache`` even after growth (before any prefill work)."""
        s = req.tokens.shape[1]
        if s + req.max_new - 1 > self.max_cache:
            raise CacheOverflowError(
                f"{where}prompt_len {s} + max_new {req.max_new} needs "
                f"{s + req.max_new - 1} cache rows > max_cache "
                f"{self.max_cache}; raise max_cache or shorten the request"
            )

    def prefill(self, tokens: np.ndarray):
        """One request's prefill at its (batch, seq) bucket: ``(first
        (bp,) device tensor, cache, kvb)`` -- the greedy token at each
        row's last REAL prompt position, the kv-bucket cache (already
        registered as pool leases: the caller releases it), and its
        length."""
        b, s = tokens.shape
        bp = self.batch_bucket(b)
        sp = self.seq_bucket(s)
        toks = np.zeros((bp, sp), np.int64)
        toks[:b, :s] = tokens
        kvb = self.kv_bucket(sp)  # the prefill-emitted cache length
        self._note(self._prefill_seen, (bp, sp), "prefill_buckets",
                   "bucket_hits")
        # With graphs on the prefill writes into leased leaves, so the
        # decode graphs find the addresses they captured; with graphs off
        # it emits fresh leaves, adopted as leases (the reference's way).
        out = None if self.graphs is None else self.lease_cache(bp, kvb)
        try:
            with self.engine.use():
                logits, cache, stats = prefill_step(
                    self.cfg, self.params,
                    torch.from_numpy(toks).to(self.device),
                    cache_len=kvb, last=s - 1, out_cache=out,
                )
        except BaseException:
            if out is not None:
                self.release_cache(out)
            raise
        self._note_moe(stats["dropped_frac"])
        if out is None:
            self.adopt_cache(cache)
        return logits.argmax(-1), cache, kvb

    def decode_vec(
        self, cache: dict, tokens: torch.Tensor, pos: torch.Tensor
    ) -> torch.Tensor:
        """One mixed-progress decode step: ``tokens`` (bp, 1) and ``pos``
        (bp,) int32 on the device, each row at its own position; the new
        k/v rows land in ``cache`` in place, and every attention layer
        makes one ``decode_attention`` dispatch with per-row kv_len.
        Returns the logits (bp, vocab_padded).  Counts first and repeat
        use of its own (bp, kvb) key (the reference's vector-pos
        programs); with graphs on, it replays the vector-form graph of
        (bp, kvb, this cache)."""
        return self._decode(cache, tokens, pos, self._decode_vec_seen)

    def _decode(self, cache: dict, tokens: torch.Tensor, pos, seen: set):
        """One decode step of every row (``pos`` an int or (bp,)),
        counted on ``seen``'s (bp, kvb) keys; returns the logits, a tensor
        the caller owns.  With graphs on the step is one replay of the
        key's graph, captured at the key's first step."""
        bp = tokens.shape[0]
        kvb = next(self._cache_leaves(cache)).shape[3]
        self._note(seen, (bp, kvb), "decode_buckets", "decode_bucket_hits")
        if self.graphs is None:
            logits, dropped = self._step(cache, tokens, pos)
        else:
            key = self._graph_key(cache, bp, pos)
            g = self.graphs.get(key)
            if g is None:
                g = self._capture(cache, tokens, pos)
            logits, dropped = self.graphs.replay(g, tokens, pos)
            self.stats["decode_graph_replays"] += 1
            logits = logits.clone()  # never hand out the static output
        self._note_moe(dropped)
        return logits

    def _step(self, cache: dict, tokens: torch.Tensor, pos):
        """The eager decode step: ``(logits, MoE dropped_frac)``."""
        with self.engine.use():
            logits, _, stats = decode_step(
                self.cfg, self.params, cache, tokens, pos
            )
        return logits, stats["dropped_frac"]

    def _graph_key(self, cache: dict, bp: int, pos) -> tuple:
        """(form, bp, kvb, every cache leaf's address): a graph replays
        only against the cache it captured."""
        leaves = list(self._cache_leaves(cache))
        form = "vector" if torch.is_tensor(pos) else "scalar"
        return (form, bp, leaves[0].shape[3],
                tuple(leaf.data_ptr() for leaf in leaves))

    def _capture(self, cache: dict, tokens: torch.Tensor, pos):
        g = self.graphs.capture(
            self._graph_key(cache, tokens.shape[0], pos),
            lambda t, p: self._step(cache, t, p), tokens, pos,
        )
        self.stats["decode_graph_captures"] += 1
        return g

    def generate(self, req: Request) -> np.ndarray:
        """Greedy tokens ``(batch, max_new)`` for one request.
        ``decode_stats`` counts each token's decode step as one launch:
        one graph replay on the card, one eager step with graphs off."""
        self.check_fits(req)
        b, s = req.tokens.shape
        tok, cache, kvb = self.prefill(req.tokens)
        pos = s - 1
        st = self.decode_stats
        # The finally arm settles the cache leases on retirement AND on any
        # exception.
        try:
            out = [tok.cpu().numpy()]
            for _ in range(req.max_new - 1):
                pos += 1
                needed = pos + 1  # rows the cache must hold after this step
                st.calls += 1
                if needed > kvb and kvb < self.max_cache:
                    kvb = self._grown_kv_bucket(kvb, needed)
                    cache = self._grow_cache(cache, kvb)
                    st.unaligned_calls += 1
                else:
                    st.aligned_calls += 1
                logits = self._decode(cache, tok[:, None], pos,
                                      self._decode_seen)
                st.launches += 1
                tok = logits.argmax(-1)
                out.append(tok.cpu().numpy())
        finally:
            self.release_cache(cache)
        return np.stack(out, 1)[:b]  # (b, max_new)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-gpt2-124m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument(
        "--warmup", action="store_true",
        help="build every attention and grouped-GEMM executable (and, on "
             "the card, capture every decode graph) first",
    )
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    server = VortexServer(
        cfg, max_cache=256, seed=args.seed, device=args.device
    )
    if args.warmup:
        n = server.warmup(max_batch=8, m_max=64, max_new=args.max_new)
        print(f"warmup: {n} executables built")
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
    for i in range(args.requests):
        b = int(rng.integers(1, 9))
        s = int(rng.integers(4, 65))
        req = Request(
            tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
            max_new=args.max_new,
        )
        out = server.generate(req)
        print(f"req {i:3d}: batch={b:3d} prompt={s:3d} -> {out.shape}")
    dt = time.perf_counter() - t0
    print(
        f"{args.requests} dynamic requests in {dt:.1f}s on "
        f"{server.device}; prefill_buckets={server.stats['prefill_buckets']} "
        f"bucket_hits={server.stats['bucket_hits']} "
        f"decode_buckets={server.stats['decode_buckets']} "
        f"decode_bucket_hits={server.stats['decode_bucket_hits']}"
    )
    ds = server.decode_stats
    print(
        f"decode: tokens={ds.calls} steps={ds.launches} "
        f"growth_copies={ds.stage_copies} padded={ds.padded_calls} "
        f"graph_captures={server.stats['decode_graph_captures']} "
        f"graph_replays={server.stats['decode_graph_replays']}"
    )
    if cfg.moe is not None:
        print(f"moe: mean dropped_frac={server.mean_dropped_frac():.6f} "
              "over every prefill and decode forward")
    for kind, d in server.engine_dispatch_stats().items():
        if kind == "kv_pool":  # lease ledger, not dispatch counters
            print(
                f"kv_pool: leases_active={d['leases_active']} "
                f"leases_peak={d['leases_peak']} hits={d['lease_hits']} "
                f"allocs={d['lease_allocs']} released={d['released']}"
            )
            continue
        if kind == "calibration":  # engine-level counters, not a kind
            if d.get("enabled"):
                print(
                    f"calibration: mode={d['mode']} applied={d['applied']} "
                    f"loaded={d['loaded_from_disk']} swaps={d['table_swaps']} "
                    f"seconds={d['seconds']:.3f}"
                )
            continue
        print(
            f"engine/{kind}: launches={d['launches']} "
            f"stage_copies={d['stage_copies']} "
            f"unstage_copies={d['unstage_copies']} "
            f"padded={d['padded_calls']}"
        )


if __name__ == "__main__":
    main()
