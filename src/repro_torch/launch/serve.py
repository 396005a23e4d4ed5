"""Dynamic-shape serving driver (counterpart of src/repro/launch/serve.py).

Requests arrive with arbitrary batch sizes and prompt lengths.  The server
quantizes both through the vortex engine session it owns:

  * the sequence dim is bucketed by the engine's own selection machinery —
    ``CompiledOp.bucket`` over the model's GEMM signature, the same lattice
    breakpoints the runtime selector bisects;
  * the request batch dim is pow2-bucketed (``vortex.pow2_bucket``).

Each request is one prefill at its (batch-bucket, seq-bucket) shape, then
one decode step per token, all under ``engine.use()`` so prefill attention
and every decode token's attention dispatch through the engine — on the
card, through the hand-written kernels.  Two prefill programs sit behind
the reference's knob ``prefill="aot" | "chained"``:

  * ``"aot"`` (the default): on the card ONE replay of a CUDA graph
    captured per (batch bucket, seq bucket, cache) (launch/graphs.py), the
    counterpart of the reference's AOT prefill programs; ``graphs=False``,
    or the CPU, runs the same forward eagerly, op by op;
  * ``"chained"``: the whole model eagerly through the engine, every
    projection and the LM head an engine ``gemm`` and every dispatch
    output a bucket-shaped :class:`~repro_torch.core.engine.LazyBucket`
    that the next dispatch consumes directly (``prefill_chained``), at a
    seq bucket where the whole chain is aligned (``chain_seq_bucket``).
    An architecture the chain does not serve (MoE, MLA, Mamba) runs the
    ``"aot"`` program, and ``stats["chained_prefills"]`` does not move.

On the card a decode step is ONE replay of a CUDA graph captured per
(form, batch bucket, kv bucket, cache), the counterpart of the
reference's AOT decode programs; ``graphs=False``, or the CPU, runs the
same step eagerly, op by op.  The KV cache lives in
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
While the tracer is on (runtime/trace.py) each prefill and decode step is
a ``vx.serve.prefill`` / ``vx.serve.decode`` span, and an MoE model's
steps also hand out their expert choices (one more static output of a
graph captured while it is on), whose kept assignments of the real tokens
are counted on the device into the tracer's routing ring.

Unlike the reference, the first generated token is the argmax at the last
REAL prompt position (s - 1), not at the last padded position of the
sequence bucket, in both prefill programs (ROADMAP C1), and a Mamba
layer's state is that of row s - 1, not of the bucket's last pad row
(ROADMAP C11).

Besides attention's k/v, the cache holds MLA's ``ckv``/``k_rope`` (a
sequence axis, grown like k/v, leased zeroed: MLA's absorbed decode
multiplies masked rows by 0, so their tails must be finite) and Mamba's
``conv``/``ssm`` state (no sequence axis: never grown, written whole by
the prefill), and whisper's ``encoder_out`` (a bare leaf, leased like the
others, written whole by the prefill, read by every decode step's
cross-attention, never grown).  The frontends are stubs fed zeros, as in
the reference: whisper's encoder frames, internvl2's patch embeddings; a
prompt shorter than the vision prefix is refused
(:class:`VisionPrefixError`).  These families run the serial
``generate()``; the continuous-batching scheduler refuses them, as the
reference's does.

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
``python -m repro_torch.launch.serve --prefill chained --requests 8``
``python -m repro_torch.launch.serve --arch whisper-small --requests 8``
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.engine import DispatchStats, LazyBucket, lazy_map
from repro_torch.core.workloads import (
    AttentionWorkload,
    DecodeAttentionWorkload,
    GemmWorkload,
    GroupedGemmWorkload,
)
from repro_torch.core.hardware import get_hardware
from repro_torch.launch.graphs import DecodeGraphs, PrefillGraphs
from repro_torch.models.layers import (
    block_forward_lazy,
    lazy_matmul,
    moe_capacity,
    norm,
    sinusoid,
)
from repro_torch.models.model import (
    CACHE_SEQ_AXIS,
    _slice,
    abstract_cache,
    decode_step,
    prefill_step,
)
from repro_torch.models.partitioning import make_rules
from repro_torch.models.params import init_params
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.runtime import faults, trace
from repro_torch.vortex import CompiledOp, Engine, EngineConfig, pow2_bucket

__all__ = [
    "VortexServer",
    "Request",
    "KVBucketPool",
    "RequestError",
    "QueueFullError",
    "DeadlineExceeded",
    "CacheOverflowError",
    "VisionPrefixError",
    "MeshServingError",
]


class CacheOverflowError(ValueError):
    """The request cannot fit ``max_cache`` even after growth — refused up
    front, before any prefill work, by both admission paths: the serial
    ``generate()`` and the scheduler's ``submit()``."""


class MeshServingError(ValueError):
    """The server was handed a mesh of more than one rank."""


class VisionPrefixError(ValueError):
    """The prompt is shorter than the model's vision prefix: refused before
    any prefill work (ROADMAP C13).  The prefix's patch embeddings
    overwrite the first ``vision_prefix`` positions, so a shorter prompt
    holds no text, and the reference's forward breaks on a seq bucket
    shorter than the prefix."""


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

    ``zero=True`` zeroes a parked buffer in place before handing it out
    (the reference allocates fresh zeros instead): the address stays the
    one a captured graph binds.

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

    def lease(self, shape, dtype, device, tag: str = "", *,
              zero: bool = False) -> torch.Tensor:
        """One bucket-shaped buffer: a parked one when available (stale
        contents — read it through a kv_len mask — or zeroed in place with
        ``zero``), else fresh zeros."""
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
        elif zero:
            buf.zero_()
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

    ``prefill``: ``"aot"`` (the default) or ``"chained"``, the
    reference's knob (see the module docstring); anything else raises
    ValueError.

    ``graphs``: None (the default) replays one captured CUDA graph per
    decode step and per ``"aot"`` prefill on the card and runs both
    eagerly on the CPU; ``False`` runs them eagerly on the card too, for
    comparison.  A capture or replay that fails raises and settles its
    leases: the eager step is never a fallback.  ``stats`` counts
    ``decode_graph_captures``/``decode_graph_replays``,
    ``prefill_graph_captures``/``prefill_graph_replays`` and
    ``chained_prefills`` beside the reference's bucket counters
    (``prefill_buckets`` is the reference's ``prefill_compiles``).

    ``mesh``: a one-rank DeviceMesh (``launch.mesh.make_host_mesh()``,
    the reference's serving mesh, src/repro/launch/serve.py:910) builds
    ``self.rules`` the reference's way and every prefill and decode step
    runs under them.  Its leaves stay plain tensors, so the constraints
    are no-ops and the CUDA graphs and kernels serve as without one.  A
    mesh of more ranks raises :class:`MeshServingError` (ROADMAP A13.2).
    """

    # The head width of the kv-bucket source of a model with no attention
    # layer (MLA and Mamba decode inline, never through the workload).
    KV_BUCKET_HEAD_DIM = 128
    # Cache leaves a lease hands out zeroed: MLA's absorbed decode masks
    # scores but multiplies the masked rows' values by 0.
    _LEASE_ZEROED = ("ckv", "k_rope")

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
        prefill: str = "aot",
        mesh=None,
    ):
        if prefill not in ("aot", "chained"):
            raise ValueError(
                f"prefill must be 'aot' or 'chained', got {prefill!r}"
            )
        self.prefill_mode = prefill
        self.cfg = cfg
        if mesh is not None and mesh.size() != 1:
            raise MeshServingError(
                f"the server runs on a one-rank mesh; got {mesh}")
        self.mesh = mesh
        self.rules = (make_rules(mesh, n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads)
                      if mesh is not None else None)
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
        # buckets (== the kv buckets prefill attention streams) at the
        # attention layers' head width.  With no attention layer the
        # width is a fixed one: falcon-mamba's resolved head_dim is its
        # whole d_model, whose lattice is empty on the H100 (ROADMAP C12).
        kv_hd = (cfg.resolved_head_dim
                 if any(spec.mixer == "attn" for spec in cfg.pattern)
                 else self.KV_BUCKET_HEAD_DIM)
        self._decode_op = CompiledOp(engine, engine.kernel_for(
            DecodeAttentionWorkload(seq=None, head_dim=kv_hd)
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
            "prefill_graph_captures": 0, "prefill_graph_replays": 0,
            "chained_prefills": 0,
        }
        if graphs is None:
            graphs = self.device.type == "cuda"
        # Decode and prefill graphs keep their own LRUs and share one
        # memory pool.
        self.graphs = DecodeGraphs(engine, self.device) if graphs else None
        self.prefill_graphs = (
            PrefillGraphs(engine, self.device, self.graphs.memory)
            if graphs else None
        )
        # Lazy-chain prefill state: per-(bp, sp) alignment verdicts, the
        # per-layer params in execution order, and the dense head matrix.
        self._chain_aligned_cache: dict[tuple[int, int], bool] = {}
        self._chain_layer_cache: list | None = None
        self._head_cache: torch.Tensor | None = None
        # Per-token decode accounting: one step per token, zero pad
        # fallbacks, a stage copy only when the cache grows.
        self.decode_stats = DispatchStats()
        # MoE capacity drops: the sum of every forward's mean dropped_frac
        # (a device scalar, read only by mean_dropped_frac) and the count.
        self._dropped_sum = torch.zeros((), device=self.device)
        self._moe_forwards = 0
        # The frontend stubs' zero inputs, per batch bucket (_frontend).
        self._frontend_cache: dict[int, dict] = {}

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
        """Every leaf of a cache, in its order: each pattern position's
        dict of leaves, and the bare ``encoder_out`` leaf."""
        for entry in cache.values():
            if isinstance(entry, dict):
                yield from entry.values()
            else:
                yield entry

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
        through the kv_len mask, but MLA's leaves come zeroed, and the
        prefill writes ``encoder_out`` whole."""
        spec = abstract_cache(self.cfg, batch, cache_len)
        tag = self._tag(shared)
        cache: dict = {}
        leased: list[torch.Tensor] = []

        def lease(name, leaf):
            buf = self.kv_pool.lease(leaf.shape, leaf.dtype, self.device, tag,
                                     zero=name in self._LEASE_ZEROED)
            leased.append(buf)
            return buf

        try:
            for key, entry in spec.items():
                cache[key] = (
                    {name: lease(name, leaf) for name, leaf in entry.items()}
                    if isinstance(entry, dict) else lease(key, entry))
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
        """Copy every leaf with a sequence axis (``CACHE_SEQ_AXIS``) into a
        ``new_len``-long leased bucket buffer (one in-place copy of the
        valid extent per leaf, only at bucket transitions), then release
        the outgrown leaves; Mamba state and ``encoder_out`` pass through
        as they are (src/repro/launch/serve.py:537-539).
        Two-phase: a failure mid-grow releases the partial new set and
        leaves ``cache`` untouched for the caller's settling ``finally``."""
        tag = self._tag(shared)
        new_leases: list[torch.Tensor] = []
        old: list[torch.Tensor] = []
        out: dict = {}
        try:
            for key, entry in cache.items():
                if not isinstance(entry, dict):  # encoder_out
                    out[key] = entry
                    continue
                grown = {}
                for name, leaf in entry.items():
                    ax = CACHE_SEQ_AXIS.get(name)
                    if ax is None or leaf.shape[ax] >= new_len:
                        grown[name] = leaf
                        continue
                    shape = list(leaf.shape)
                    shape[ax] = new_len
                    buf = self.kv_pool.lease(
                        shape, leaf.dtype, leaf.device, tag,
                        zero=name in self._LEASE_ZEROED)
                    new_leases.append(buf)
                    buf.narrow(ax, 0, leaf.shape[ax]).copy_(leaf)
                    grown[name] = buf
                    old.append(leaf)
                out[key] = grown
        except BaseException:
            for buf in reversed(new_leases):
                self.kv_pool.release(buf, tag)
            raise
        for leaf in reversed(old):
            self.kv_pool.release(leaf, tag)
        self.decode_stats.stage_copies += len(old)
        return out

    @staticmethod
    def _cache_len(cache: dict) -> int:
        """The length of a cache's leaves that have a sequence axis."""
        for entry in cache.values():
            if not isinstance(entry, dict):  # encoder_out
                continue
            for name, leaf in entry.items():
                if name in CACHE_SEQ_AXIS:
                    return leaf.shape[CACHE_SEQ_AXIS[name]]
        raise ValueError("the cache has no leaf with a sequence axis: "
                         "pass its kv bucket")

    # -- warmup -------------------------------------------------------------

    def warmup(
        self, *, max_batch: int = 1, m_max: int | None = None,
        max_new: int = 8, capture: bool = True,
    ) -> int:
        """Build, before traffic, every executable the requests up to
        ``max_batch``/``m_max``/``max_new`` can reach (and, on the card,
        the kernel library itself): prefill attention over the seq
        buckets, an encoder's non-causal attention at ``encoder_seq``,
        decode attention over the kv buckets and, for an MoE
        model, the grouped-GEMM capacity buckets that the seq buckets and
        decode (s = 1) imply, per batch bucket.  With graphs on and
        ``capture``, also capture the scalar-form decode graph of every
        reachable (batch bucket, kv bucket) (``generate()``'s) and, where
        the ``"aot"`` program serves the prefills, the prefill graph of
        every reachable (batch bucket, seq bucket) -- as the reference
        AOT-compiles both, save the seq buckets shorter than a vision
        prefix, which no prompt reaches (ROADMAP C13) -- each against a
        cache leased from the pool and parked again, so that a later
        request of that shape leases the same leaves and replays it (a
        large model passes ``capture=False``: every parked cache stays
        allocated).  Returns the number of executables built."""
        cfg, eng = self.cfg, self.engine
        m_max = self.max_cache if m_max is None else min(m_max, self.max_cache)
        hd = cfg.resolved_head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads
        attn_specs = [spec for spec in cfg.pattern if spec.mixer == "attn"]
        attn = {
            eng.kernel_for(AttentionWorkload(
                seq=None, head_dim=hd, causal=True, window=spec.window,
                softcap=cfg.attn_softcap,
            ))
            for spec in attn_specs
        }
        dec = {
            eng.kernel_for(DecodeAttentionWorkload(
                seq=None, head_dim=hd, causal=True, window=spec.window,
                softcap=cfg.attn_softcap,
            ))
            for spec in attn_specs
        }
        enc = set()
        if cfg.encoder_decoder:
            enc = {eng.kernel_for(AttentionWorkload(
                seq=None, head_dim=hd, causal=False, window=None,
                softcap=cfg.attn_softcap,
            ))}
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
            return sum(k.cache_info["entries"]
                       for k in attn | dec | enc | grouped)

        before = built()
        for bp in bps:
            for k in attn:
                k.precompile(m_max, meta(bp, H, 1, hd), meta(bp, KV, 1, hd),
                             meta(bp, KV, 1, hd))
            for k in dec:
                k.precompile(m_kv, meta(bp, H, 1, hd), meta(bp, KV, 1, hd),
                             meta(bp, KV, 1, hd), 1)
            for k in enc:
                k.precompile(cfg.encoder_seq, meta(bp, H, 1, hd),
                             meta(bp, KV, 1, hd), meta(bp, KV, 1, hd))
        for k in grouped:
            k.precompile(c_max)
        if capture and self.graphs is not None:
            for bp in bps:
                tokens = torch.zeros((bp, 1), dtype=torch.int64,
                                     device=self.device)
                for kvb in self.decode_buckets(m_max=m_max, max_new=max_new):
                    cache = self.lease_cache(bp, kvb)
                    try:
                        if self.graphs.get(
                                self._graph_key(cache, bp, 0, kvb)) is None:
                            self._capture(cache, tokens, 0, kvb)
                    finally:
                        self.release_cache(cache)
                if self._chained():
                    continue
                for sp in self.seq_buckets(m_max):
                    if sp < cfg.vision_prefix:
                        continue
                    kvb = self.kv_bucket(sp)
                    cache = self.lease_cache(bp, kvb)
                    try:
                        if self.prefill_graphs.get(
                                self._prefill_key(cache, bp, sp)) is None:
                            self._capture_prefill(
                                cache, torch.zeros((bp, sp),
                                                   dtype=torch.int64),
                                sp - 1, kvb)
                    finally:
                        self.release_cache(cache)
        return built() - before

    # -- lazy-handle chained prefill ----------------------------------------

    def _prefill_chained_supported(self) -> bool:
        """True when every layer of the architecture runs through the lazy
        handle chain (plain attn mixer, dense/none MLP, no cross-attention,
        no vision prefix / encoder stack)."""
        cfg = self.cfg
        if cfg.vision_prefix or cfg.encoder_decoder:
            return False
        return all(
            spec.mixer == "attn" and spec.mlp in ("dense", "none")
            and not spec.cross_attn
            for spec in cfg.pattern
        )

    def _chained(self) -> bool:
        """True when prefills run through the chain (the knob, and an
        architecture it serves)."""
        return (self.prefill_mode == "chained"
                and self._prefill_chained_supported())

    def _chain_gemm_sigs(self) -> list[tuple[int, int]]:
        """Every (K, N) GEMM signature the chained prefill dispatches:
        q/k/v/o projections, the MLP pair, and the LM head."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        sigs = {
            (d, cfg.n_heads * hd),        # wq
            (d, cfg.n_kv_heads * hd),     # wk / wv
            (cfg.n_heads * hd, d),        # wo
            (d, cfg.vocab_padded),        # lm head
        }
        if any(spec.mlp == "dense" for spec in cfg.pattern):
            sigs.add((d, cfg.d_ff))       # w_in / w_gate
            sigs.add((cfg.d_ff, d))       # w_out
        return sorted(sigs)

    def _chain_aligned(self, bp: int, sp: int) -> bool:
        """True when EVERY dispatch of a (bp, sp) chained prefill lands on
        its own bucket: each chain GEMM's selection at m = bp*sp pads to
        exactly bp*sp, the attention bucket at sp is (sp, hd, sp), and the
        kv cache bucket covering sp is sp itself -- so handles forward
        bucket-to-bucket with zero boundary copies end to end."""
        key = (bp, sp)
        hit = self._chain_aligned_cache.get(key)
        if hit is None:
            eng, cfg = self.engine, self.cfg
            hd = cfg.resolved_head_dim
            m = bp * sp
            ok = all(
                eng.kernel_for(
                    GemmWorkload(M=None, N=n, K=k)
                ).select(m).padded_m == m
                for k, n in self._chain_gemm_sigs()
            )
            if ok:
                for window in {
                    spec.window for spec in cfg.pattern
                    if spec.mixer == "attn"
                }:
                    kern = eng.kernel_for(AttentionWorkload(
                        seq=None, head_dim=hd, causal=True,
                        window=window, softcap=cfg.attn_softcap,
                    ))
                    if kern.select(sp).bucket != (sp, hd, sp):
                        ok = False
                        break
            hit = ok and self.kv_bucket(sp) == sp
            self._chain_aligned_cache[key] = hit
        return hit

    def chain_seq_bucket(self, s: int, bp: int = 1) -> int:
        """The sequence bucket a chained prefill serves ``s`` at: the first
        engine bucket >= seq_bucket(s) where the whole chain is aligned
        (``_chain_aligned``), falling back to seq_bucket(s) when none is --
        a misaligned chain stays correct, it just pays counted boundary
        copies."""
        base = self.seq_bucket(s)
        for sp in self.seq_buckets():
            if sp >= base and self._chain_aligned(bp, sp):
                return sp
        return base

    def _chain_layers(self) -> list:
        """(spec, params) per layer in execution order (group-major), as
        views of the stacked parameter tree."""
        if self._chain_layer_cache is None:
            cfg = self.cfg
            self._chain_layer_cache = [
                (spec, _slice(self.params[f"pos{i}"], g))
                for g in range(cfg.n_groups)
                for i, spec in enumerate(cfg.pattern)
            ]
        return self._chain_layer_cache

    def _head(self) -> torch.Tensor:
        """The LM head as a dense (d, vocab_padded) matrix: a tied
        embedding's transpose is copied once per server (the kernels take
        dense operands)."""
        if self._head_cache is None:
            self._head_cache = (
                self.params["embed"].T.contiguous()
                if self.cfg.tie_embeddings else self.params["lm_head"]
            )
        return self._head_cache

    @staticmethod
    def _chain_cache_leaf(t) -> torch.Tensor:
        """A chain k/v projection as a dense (b, KV, s, hd) tensor: the
        chain's fully-valid handles realize as their own buffer."""
        return t.realize() if isinstance(t, LazyBucket) else t

    def prefill_chained(self, bp: int, sp: int, tokens: torch.Tensor, *,
                        last: int, eager: bool = False,
                        out_cache: dict | None = None):
        """Whole-model prefill as a lazy handle chain: embed (plain ops) ->
        per-layer ``block_forward_lazy`` -> final norm / head / softcap /
        vocab mask via ``lazy_map`` -- every engine boundary passes a
        LazyBucket, so at a chain-aligned ``sp`` nothing unstages between
        dispatches.  ``tokens`` is the (bp, sp) padded batch on the device.
        Returns ``(logits (bp, vocab_padded), cache)`` like the ``"aot"``
        prefill: the logits at row ``last`` (the last real prompt token,
        s - 1, read from the logits handle's buffer without realizing it;
        the reference reads sp - 1, ROADMAP C1), the cache kv-bucket
        shaped.  With ``out_cache`` (a leased cache) each layer's k and v
        are copied into its leaves' first sp rows, one copy each; without,
        fresh zero-padded leaves are stacked, as the reference does.

        ``eager=True`` runs the IDENTICAL dispatch sequence on plain
        tensors (per-op stage/unstage) -- the bit-identity reference."""
        cfg = self.cfg
        eng = self.engine
        lazy = not eager

        # Pre-block embedding, as the model's forward does it.
        x = self.params["embed"][tokens]
        if cfg.embed_scale:
            x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
        positions = torch.arange(sp, device=x.device)
        if not cfg.use_rope:
            x = x + sinusoid(positions, cfg.d_model).to(x.dtype)

        if lazy:
            x = LazyBucket(x, sp, 1)
        kvs = []
        for spec, p in self._chain_layers():
            x, kv = block_forward_lazy(
                eng, p, x, cfg, spec, positions=positions, lazy=lazy,
            )
            kvs.append(kv)

        x = lazy_map(lambda t: norm(t, self.params["final_norm"], cfg), x)
        logits = lazy_matmul(eng, x, self._head(), lazy=lazy)
        if cfg.logit_softcap is not None:
            c = cfg.logit_softcap
            logits = lazy_map(
                lambda t: (torch.tanh(t.float() / c) * c).to(t.dtype),
                logits,
            )
        if cfg.vocab_padded != cfg.vocab:
            def mask(t):
                t = t.clone()
                t[..., cfg.vocab:] = -1e30  # argmax never sees the pad
                return t
            logits = lazy_map(mask, logits)
        # Row ``last`` of the handle's buffer is a real row: read it
        # without forcing a slice.
        buf = logits.buffer if isinstance(logits, LazyBucket) else logits
        last_logits = buf[:, last].contiguous()

        kvb = self.kv_bucket(sp)
        n_pos = len(cfg.pattern)
        cache: dict = {}
        for i in range(n_pos):
            entry = {}
            for name in ("k", "v"):
                layers = [self._chain_cache_leaf(kvs[g * n_pos + i][name])
                          for g in range(cfg.n_groups)]
                if out_cache is not None:
                    dst = out_cache[f"pos{i}"][name]
                    for g, t in enumerate(layers):
                        dst[g, :, :, :t.shape[2]].copy_(t)
                    entry[name] = dst
                else:
                    entry[name] = torch.stack([
                        F.pad(t, (0, 0, 0, kvb - t.shape[2]))
                        for t in layers
                    ])
            cache[f"pos{i}"] = entry
        return last_logits, cache

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

    def _check_prompt(self, s: int, where: str = "") -> None:
        """Raise :class:`VisionPrefixError` for a prompt of ``s`` tokens
        shorter than the vision prefix."""
        nv = self.cfg.vision_prefix
        if s < nv:
            raise VisionPrefixError(
                f"{where}prompt_len {s} < vision_prefix {nv}: the prompt "
                f"must hold the {nv} image positions the patch embeddings "
                "overwrite"
            )

    def check_fits(self, req: Request, where: str = "") -> None:
        """Raise :class:`CacheOverflowError` when ``req`` cannot fit
        ``max_cache`` even after growth, and :class:`VisionPrefixError`
        when its prompt is shorter than the vision prefix (both before
        any prefill work)."""
        s = req.tokens.shape[1]
        self._check_prompt(s, where)
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
        length.  Runs the chain (``prefill="chained"`` on an architecture
        it serves, at ``chain_seq_bucket``), else the ``"aot"`` program at
        ``seq_bucket``: one graph replay with graphs on, the eager forward
        with graphs off.  A prompt shorter than the vision prefix raises
        :class:`VisionPrefixError` before any work."""
        with trace.span("vx.serve.prefill"):
            return self._prefill(tokens)

    def _prefill(self, tokens: np.ndarray):
        b, s = tokens.shape
        self._check_prompt(s)
        bp = self.batch_bucket(b)
        chained = self._chained()
        sp = self.chain_seq_bucket(s, bp) if chained else self.seq_bucket(s)
        toks = torch.zeros((bp, sp), dtype=torch.int64)
        toks[:b, :s] = torch.from_numpy(np.asarray(tokens))
        kvb = self.kv_bucket(sp)  # the prefill-emitted cache length
        if not chained:
            self._note(self._prefill_seen, (bp, sp), "prefill_buckets",
                       "bucket_hits")
        # With graphs on the prefill writes into leased leaves, so the
        # graphs find the addresses they captured; with graphs off it
        # emits fresh leaves, adopted as leases (the reference's way).
        out = None if self.graphs is None else self.lease_cache(bp, kvb)
        dropped, topi = None, ()
        try:
            if chained:
                logits, cache = self.prefill_chained(
                    bp, sp, toks.to(self.device), last=s - 1, out_cache=out)
            elif out is None:
                logits, dropped, cache, *topi = self._prefill_eager(
                    None, toks.to(self.device), s - 1, kvb,
                    routing=self._routing())
            else:
                logits, dropped, *topi = self._prefill_graphed(
                    out, toks, s - 1, kvb)
                cache = out
        except BaseException:
            if out is not None:
                self.release_cache(out)
            raise
        if chained:
            self.stats["chained_prefills"] += 1
        else:
            self._note_moe(dropped)
        if topi and trace.ACTIVE is not None:
            live = torch.zeros((bp, sp), dtype=torch.int32,
                               device=self.device)
            live[:b, :s] = 1
            self._count_routing("prefill", topi[0], live)
        if out is None:
            self.adopt_cache(cache)
        return logits.argmax(-1), cache, kvb

    def _prefill_eager(self, cache: dict | None, tokens: torch.Tensor,
                       last, kvb: int, routing: bool = False):
        """The eager ``"aot"`` forward: ``(first-token logits, MoE
        dropped_frac, cache)``, the cache written into ``cache`` in place
        (with ``cache`` None, emitted fresh); with ``routing``, the MoE
        layers' stacked expert choices (layers, bp, sp, top_k) last."""
        with self.engine.use():
            logits, cache, stats = prefill_step(
                self.cfg, self.params, tokens, cache_len=kvb, last=last,
                out_cache=cache, rules=self.rules,
                **self._frontend(tokens.shape[0]),
            )
        out = (logits, stats["dropped_frac"], cache)
        return out + (torch.stack(stats["topi"]),) if routing else out

    def _routing(self) -> bool:
        """Whether a step hands out its expert choices: an MoE model while
        the tracer is on."""
        return trace.ACTIVE is not None and self.cfg.moe is not None

    def _count_routing(self, kind: str, topi: torch.Tensor,
                       live: torch.Tensor) -> None:
        """File one step's kept assignments per (MoE layer, expert) with
        the tracer, on the device.  ``topi`` (layers, b, s, top_k) are the
        choices and ``live`` (b, s) marks the real tokens.  Each batch row
        is a routing group whose experts admit their first
        ``moe_capacity(s)`` assignments in (token, choice) order, and real
        tokens precede a row's pad, so a row keeps min(its real tokens'
        assignments, capacity) per expert."""
        n, b, s, k = topi.shape
        src = live[None, :, :, None].expand(n, b, s, k).reshape(n, b, s * k)
        cnt = torch.zeros((n, b, self.cfg.moe.num_experts),
                          dtype=torch.int32, device=topi.device)
        cnt.scatter_add_(2, topi.reshape(n, b, s * k), src)
        cnt.clamp_(max=moe_capacity(self.cfg, s))
        trace.ACTIVE.routed(kind, cnt.sum(1, dtype=torch.int32))

    def _frontend(self, bp: int) -> dict:
        """The frontend stubs' inputs for a batch bucket, as the
        reference's ``_make_batch`` feeds them (src/repro/launch/
        serve.py:382-398): zero frame embeddings (bp, encoder_seq, d) for
        an encoder-decoder, zero patch embeddings (bp, vision_prefix, d)
        for a VLM.  Made once per bucket; nothing writes them."""
        got = self._frontend_cache.get(bp)
        if got is None:
            cfg = self.cfg
            dt = self.params["embed"].dtype
            got = {}
            if cfg.encoder_decoder:
                got["encoder_frames"] = torch.zeros(
                    (bp, cfg.encoder_seq, cfg.d_model), dtype=dt,
                    device=self.device)
            if cfg.vision_prefix:
                got["vision_embeds"] = torch.zeros(
                    (bp, cfg.vision_prefix, cfg.d_model), dtype=dt,
                    device=self.device)
            self._frontend_cache[bp] = got
        return got

    def _prefill_key(self, cache: dict, bp: int, sp: int) -> tuple:
        """(bp, sp, every cache leaf's address)."""
        return (bp, sp, tuple(leaf.data_ptr()
                              for leaf in self._cache_leaves(cache)))

    def _capture_prefill(self, cache: dict, tokens: torch.Tensor, last: int,
                         kvb: int):
        bp, sp = tokens.shape
        self._frontend(bp)  # the stubs' zeros exist before the capture
        routing = self._routing()

        def step(t, i):
            out = self._prefill_eager(cache, t, i, kvb, routing)
            return out[:2] + out[3:]  # the cache is bound, not an output

        g = self.prefill_graphs.capture(
            self._prefill_key(cache, bp, sp), step, tokens, last)
        self.stats["prefill_graph_captures"] += 1
        return g

    def _prefill_graphed(self, cache: dict, tokens: torch.Tensor,
                         last: int, kvb: int | None = None):
        """The ``"aot"`` prefill as one replay of the (bp, sp, cache)
        graph, captured at the key's first use: ``(first-token logits,
        dropped_frac)`` and, from a graph captured while an MoE model's
        routing was handed out, the expert choices: the graph's static
        outputs (read them before the next replay).  ``kvb`` is the
        cache's length (default: its sequence-axis leaves')."""
        bp, sp = tokens.shape
        g = self.prefill_graphs.get(self._prefill_key(cache, bp, sp))
        if g is None:
            if kvb is None:
                kvb = self._cache_len(cache)
            g = self._capture_prefill(cache, tokens, last, kvb)
        out = self.prefill_graphs.replay(g, tokens, last)
        self.stats["prefill_graph_replays"] += 1
        return out

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

    def _decode(self, cache: dict, tokens: torch.Tensor, pos, seen: set,
                kvb: int | None = None, rows: int | None = None):
        """One decode step of every row (``pos`` an int or (bp,)) against
        a cache of length ``kvb`` (default: its sequence-axis leaves'; a
        Mamba-only cache has none), counted on ``seen``'s (bp, kvb) keys;
        returns the logits, a tensor the caller owns.  With graphs on the
        step is one replay of the key's graph, captured at the key's first
        step.  With the tracer on, an MoE step's routing is counted over
        its real rows: those at ``pos > 0`` for a vector ``pos`` (the
        scheduler's free slots ride at 0), the first ``rows`` (default:
        all) for an int."""
        with trace.span("vx.serve.decode"):
            return self._decode_step(cache, tokens, pos, seen, kvb, rows)

    def _decode_step(self, cache, tokens, pos, seen, kvb, rows):
        bp = tokens.shape[0]
        if kvb is None:
            kvb = self._cache_len(cache)
        self._note(seen, (bp, kvb), "decode_buckets", "decode_bucket_hits")
        if self.graphs is None:
            logits, dropped, *topi = self._step(cache, tokens, pos,
                                                self._routing())
        else:
            key = self._graph_key(cache, bp, pos, kvb)
            g = self.graphs.get(key)
            if g is None:
                g = self._capture(cache, tokens, pos, kvb)
            logits, dropped, *topi = self.graphs.replay(g, tokens, pos)
            self.stats["decode_graph_replays"] += 1
            logits = logits.clone()  # never hand out the static output
        self._note_moe(dropped)
        if topi and trace.ACTIVE is not None:
            if torch.is_tensor(pos):
                live = pos > 0
            else:
                live = torch.arange(bp, device=self.device) < (
                    bp if rows is None else rows)
            self._count_routing("decode", topi[0],
                                live.to(torch.int32)[:, None])
        return logits

    def _step(self, cache: dict, tokens: torch.Tensor, pos,
              routing: bool = False):
        """The eager decode step: ``(logits, MoE dropped_frac)``, and with
        ``routing`` the MoE layers' stacked expert choices (layers, bp,
        1, top_k)."""
        with self.engine.use():
            logits, _, stats = decode_step(
                self.cfg, self.params, cache, tokens, pos, rules=self.rules
            )
        out = (logits, stats["dropped_frac"])
        return out + (torch.stack(stats["topi"]),) if routing else out

    def _graph_key(self, cache: dict, bp: int, pos,
                   kvb: int | None = None) -> tuple:
        """(form, bp, kvb, every cache leaf's address): a graph replays
        only against the cache it captured."""
        form = "vector" if torch.is_tensor(pos) else "scalar"
        if kvb is None:
            kvb = self._cache_len(cache)
        return (form, bp, kvb, tuple(leaf.data_ptr()
                                     for leaf in self._cache_leaves(cache)))

    def _capture(self, cache: dict, tokens: torch.Tensor, pos, kvb: int):
        # A Mamba step advances its state: the warm-up's update is undone
        # before the capture, so the replay advances it once.
        state = [leaf for entry in cache.values() if isinstance(entry, dict)
                 for name, leaf in entry.items() if name in ("conv", "ssm")]
        routing = self._routing()
        g = self.graphs.capture(
            self._graph_key(cache, tokens.shape[0], pos, kvb),
            lambda t, p: self._step(cache, t, p, routing), tokens, pos,
            state=state,
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
                                      self._decode_seen, kvb, rows=b)
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
    ap.add_argument("--prefill", choices=("aot", "chained"), default="aot",
                    help="the prefill program (see VortexServer)")
    ap.add_argument(
        "--warmup", action="store_true",
        help="build every attention and grouped-GEMM executable (and, on "
             "the card, capture every decode and prefill graph) first",
    )
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # Prompt lengths: 4-64 tokens, or a vision prefix and up to 60 more.
    lo = max(4, cfg.vision_prefix)
    hi = lo + 60
    server = VortexServer(
        cfg, max_cache=max(256, 2 * hi), seed=args.seed, device=args.device,
        prefill=args.prefill,
    )
    if args.warmup:
        n = server.warmup(max_batch=8, m_max=hi, max_new=args.max_new)
        print(f"warmup: {n} executables built")
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
    for i in range(args.requests):
        b = int(rng.integers(1, 9))
        s = int(rng.integers(lo, hi + 1))
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
        f"decode_bucket_hits={server.stats['decode_bucket_hits']} "
        f"chained_prefills={server.stats['chained_prefills']} "
        f"prefill_graph_captures={server.stats['prefill_graph_captures']} "
        f"prefill_graph_replays={server.stats['prefill_graph_replays']}"
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
            f"padded={d['padded_calls']} forwarded={d['forwarded']} "
            f"realize_slices={d['realize_slices']}"
        )


if __name__ == "__main__":
    main()
