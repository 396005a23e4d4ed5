"""Continuous batching on top of :class:`~repro_torch.launch.serve.VortexServer`
(counterpart of src/repro/launch/scheduler.py).

The serial server runs one request at a time: prefill, then one decode step
per token with the whole batch at ONE position.  This module packs
concurrent requests into the batch dimension instead:

  * an ADMISSION QUEUE (``submit``) accepts requests from any thread,
    assigns ``request_id``s, and refuses requests that could never be
    served (``prompt + max_new - 1 > max_cache``, or more rows than the
    scheduler has slots) AT SUBMIT TIME, not deep inside a decode loop;
  * a STEP SCHEDULER (``step``/``drain``) retires finished rows and admits
    queued prefills between steps, then advances every active row with ONE
    mixed-progress decode step (``VortexServer.decode_vec``): ``pos`` is a
    per-row int32 vector on the device, so rows at different kv positions
    share the step, and every attention layer makes one ``decode_attention``
    dispatch with per-row kv_len.  Free slots ride along at ``pos = 0``:
    the step writes their (finite) k/v row 0 and attends over exactly that
    one row, so a retired slot costs one key and never reads stale pool
    bytes;
  * the KV state is ONE shared set of kv-bucket buffers LEASED from the
    server's :class:`~repro_torch.launch.serve.KVBucketPool`: each admitted
    row's prefill cache is copied into its slot in place and the
    per-request buffers are released at once, and when any row outgrows
    the bucket the shared cache grows through the pool
    (``VortexServer._grow_cache``) as on the serial path.

Unlike the reference's ``_admit``, the first token of an admitted row is the
argmax at its last REAL prompt position (s - 1), as the port's serial
``generate()`` reads it (ROADMAP C1), so the scheduler's tokens equal
``generate()``'s at every prompt length.

Failure domains: a fault while admitting, growing or decoding resolves to a
typed per-request error -- ``drain()`` returns tokens *or* a
:class:`~repro_torch.launch.serve.RequestError` per request id -- and never
tears down the step loop; every failure path settles its pool leases.
``submit()`` adds backpressure: a bounded queue (``max_queue`` ->
:class:`~repro_torch.launch.serve.QueueFullError`) and per-request
wall-clock deadlines (``Request.deadline_s`` ->
:class:`~repro_torch.launch.serve.DeadlineExceeded`, the slots reused next
step).

A fully idle tick (no active row, nothing queued) donates one budgeted
slice to the engine's background calibrator when ``EngineConfig.
calibration`` is on (``stats["calibration_slices"]``); the donation is not
request work, so ``drain()`` still ends when the requests do.

``stats["rows_stepped"]`` sums the active rows over the decode steps.
While the tracer is on (runtime/trace.py) each ``step()`` is a
``vx.sched.tick`` span, each admission a ``vx.sched.admit`` span tagged
with its request id, and each device-to-host read of tokens (a prefill's
first tokens, a decode step's next ones) a ``vx.sched.readback`` span.

Supported architectures are the uniformly-attention decoders (every mixer
``attn``, no cross-attention, vision prefix or encoder stack): the shared
cache then holds only k/v leaves, whose every read goes through the kv_len
mask -- the stale-tail pool contract.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from repro_torch.launch.serve import (
    DeadlineExceeded,
    QueueFullError,
    Request,
    RequestError,
    VortexServer,
)
from repro_torch.runtime import faults, trace
from repro_torch.vortex import pow2_bucket

__all__ = ["ContinuousScheduler", "batched_decode_supported"]


def batched_decode_supported(cfg) -> bool:
    """True when the mixed-progress batched decode serves this arch: all
    mixers are plain attention (the shared cache is k/v leaves only, every
    read kv_len-masked) and there is no cross-attention, vision prefix or
    encoder stack feeding extra per-request state."""
    if cfg.vision_prefix or cfg.encoder_decoder:
        return False
    return all(
        spec.mixer == "attn" and not spec.cross_attn for spec in cfg.pattern
    )


@dataclasses.dataclass
class _Row:
    """One occupied batch slot: a single sequence of one request."""
    rid: int
    req_row: int        # which row of the request's (b, s) token block
    pos_next: int       # cache position the NEXT decode step writes
    remaining: int      # decode steps left (max_new - tokens emitted)
    last_tok: int       # feeds the next step's token vector
    out: list[int]      # generated tokens so far (prefill argmax first)
    max_new: int
    stop: int | None


class ContinuousScheduler:
    """Admission queue + mixed-progress step scheduler over a server.

    ``submit()`` is thread-safe and returns the assigned request id;
    ``step()``/``drain()`` must run on one scheduler thread.  ``drain()``
    returns ``{request_id: (b, max_new) int64 array | RequestError}`` for
    every request resolved since the previous drain.  ``close()`` releases
    the shared cache leases back to the pool (``leases_active`` returns to
    0).  ``max_queue`` bounds the admission queue (``submit`` raises
    :class:`QueueFullError` at capacity); None = unbounded.
    """

    def __init__(
        self,
        server: VortexServer,
        *,
        batch_rows: int = 8,
        max_queue: int | None = None,
    ):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if not batched_decode_supported(server.cfg):
            raise ValueError(
                "continuous batching needs a uniformly-attention decoder "
                "(every mixer 'attn', no cross-attn/vision/encoder); "
                f"arch pattern {[s.mixer for s in server.cfg.pattern]} "
                "is served by the serial generate() path"
            )
        self.server = server
        self.batch_rows = pow2_bucket(batch_rows)
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._queue: list[Request] = []
        self._next_id = 0
        self._results: dict[int, np.ndarray | RequestError] = {}
        # Per-request assembly: (buffer, rows_outstanding).
        self._partial: dict[int, tuple[np.ndarray, int]] = {}
        # rid -> (absolute monotonic deadline, the request's deadline_s).
        self._deadlines: dict[int, tuple[float, float]] = {}
        self.rows: list[_Row | None] = [None] * self.batch_rows
        self.cache: dict | None = None
        self.kvb = 0
        self.stats = {
            "steps": 0, "launches": 0, "padded_calls": 0,
            "admitted": 0, "retired": 0, "calibration_slices": 0,
            "request_errors": 0, "deadline_expired": 0, "rows_stepped": 0,
        }

    # -- admission queue ----------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request, validating it AT ADMISSION: a request that could
        never complete fails here with a clear error.  Thread-safe."""
        b = req.tokens.shape[0]
        if b > self.batch_rows:
            raise ValueError(
                f"request has {b} rows but the scheduler batches "
                f"{self.batch_rows}; split the request or raise batch_rows"
            )
        # The serial generate()'s typed error: one overflow contract.
        self.server.check_fits(req, "admission refused: ")
        with self._lock:
            if (
                self.max_queue is not None
                and len(self._queue) >= self.max_queue
            ):
                raise QueueFullError(
                    f"admission queue is full ({self.max_queue} queued "
                    "requests); drain or retry after capacity frees up"
                )
            rid = self._next_id
            self._next_id += 1
            req = dataclasses.replace(req, request_id=rid)
            self._queue.append(req)
            if req.deadline_s is not None:
                self._deadlines[rid] = (
                    time.monotonic() + req.deadline_s, req.deadline_s
                )
        return rid

    # -- shared kv cache ----------------------------------------------------

    def _ensure_cache(self, kvb: int) -> None:
        """Lease the shared kv-bucket leaves (stale pool contents are fine:
        a slot row is only read after its prefill copy or decode write, and
        always through the kv_len mask).  The leaves keep their addresses
        until the cache grows or closes, so the server's decode graphs for
        (batch_rows, kvb) replay step after step."""
        if self.cache is not None:
            return
        self.cache = self.server.lease_cache(self.batch_rows, kvb,
                                             shared=True)
        self.kvb = kvb

    def _grow(self, new_kvb: int) -> None:
        assert self.cache is not None
        self.cache = self.server._grow_cache(self.cache, new_kvb,
                                             shared=True)
        self.kvb = new_kvb

    def close(self) -> None:
        """Release the shared cache leases; idempotent, and a later
        submit/step leases again."""
        if self.cache is None:
            return
        self.server.release_cache(self.cache, shared=True)
        self.cache = None
        self.kvb = 0

    def _copy_row(self, rcache: dict, r: int, slot: int) -> None:
        """One admitted sequence: row ``r`` of its prefill-emitted cache is
        copied in place into the shared cache's slot row (the request's
        bucket may be shorter than the shared one: the slot row's tail past
        it stays stale, masked by kv_len)."""
        assert self.cache is not None
        for key, entry in self.cache.items():
            for name, leaf in entry.items():
                src = rcache[key][name]
                leaf[:, slot, :, :src.shape[3]].copy_(src[:, r])

    # -- scheduling ---------------------------------------------------------

    def _free_slots(self) -> list[int]:
        return [i for i, row in enumerate(self.rows) if row is None]

    def _fail_request(
        self, rid: int, stage: str, exc: BaseException
    ) -> None:
        """Resolve EVERY row of one request to a typed error: seated rows
        are cleared (their slots reused next step), the partial output
        dropped, and ``drain()`` returns the :class:`RequestError` in place
        of tokens.  The shared cache is untouched: other requests keep
        decoding."""
        for slot, row in enumerate(self.rows):
            if row is not None and row.rid == rid:
                self.rows[slot] = None
        self._partial.pop(rid, None)
        self._deadlines.pop(rid, None)
        err = exc if isinstance(exc, RequestError) else RequestError(
            rid, stage, f"{type(exc).__name__}: {exc}"
        )
        with self._lock:
            self._results[rid] = err
        if isinstance(err, DeadlineExceeded):
            self.stats["deadline_expired"] += 1
        else:
            self.stats["request_errors"] += 1

    def _expire_deadlines(self) -> bool:
        """Retire queued and active requests whose wall-clock deadline
        passed; True if anything expired (the tick did work)."""
        if not self._deadlines:
            return False
        now = time.monotonic()
        expired: list[tuple[int, float]] = []
        with self._lock:
            for req in list(self._queue):
                dl = self._deadlines.get(req.request_id)
                if dl is not None and now > dl[0]:
                    self._queue.remove(req)
                    expired.append((req.request_id, dl[1]))
        for rid in {row.rid for row in self.rows if row is not None}:
            dl = self._deadlines.get(rid)
            if dl is not None and now > dl[0]:
                expired.append((rid, dl[1]))
        for rid, deadline_s in expired:
            self._fail_request(
                rid, "deadline", DeadlineExceeded(rid, deadline_s)
            )
        return bool(expired)

    def _admit(self, req: Request) -> None:
        """Prefill ONE queued request through the server and seat its rows:
        per-row first token from the prefill argmax at the last real
        prompt position, cache rows copied into free slots, the transient
        per-request buffers released back to the pool."""
        with trace.span("vx.sched.admit", rid=req.request_id):
            self._admit_rows(req)

    def _admit_rows(self, req: Request) -> None:
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("scheduler_step")
        srv = self.server
        b, s = req.tokens.shape
        first, rcache, kvb_req = srv.prefill(req.tokens)
        try:
            with trace.span("vx.sched.readback"):
                first = first.cpu().numpy()  # (bp,)
            self._ensure_cache(kvb_req)
            if kvb_req > self.kvb:
                self._grow(kvb_req)
            slots = self._free_slots()
            rid = req.request_id
            assert rid is not None
            self._partial[rid] = (np.zeros((b, req.max_new), np.int64), b)
            for r in range(b):
                slot = slots[r]
                self._copy_row(rcache, r, slot)
                tok = int(first[r])
                self.rows[slot] = _Row(
                    rid=rid, req_row=r, pos_next=s,
                    remaining=req.max_new - 1, last_tok=tok, out=[tok],
                    max_new=req.max_new, stop=req.stop,
                )
                if req.stop is not None and tok == req.stop:
                    self.rows[slot].remaining = 0
        finally:
            srv.release_cache(rcache)
        self.stats["admitted"] += 1

    def _retire(self, slot: int) -> None:
        row = self.rows[slot]
        assert row is not None and row.remaining == 0
        out = row.out
        if len(out) < row.max_new:  # early stop: pad with the stop token
            out = out + [row.stop] * (row.max_new - len(out))
        buf, outstanding = self._partial[row.rid]
        buf[row.req_row] = out
        outstanding -= 1
        if outstanding:
            self._partial[row.rid] = (buf, outstanding)
        else:
            del self._partial[row.rid]
            self._deadlines.pop(row.rid, None)
            with self._lock:
                self._results[row.rid] = buf
        self.rows[slot] = None
        self.stats["retired"] += 1

    def _retire_finished(self) -> bool:
        done = [
            slot for slot, row in enumerate(self.rows)
            if row is not None and row.remaining == 0
        ]
        for slot in done:
            self._retire(slot)
        return bool(done)

    def step(self) -> bool:
        """One scheduler tick: retire finished rows, expire deadlines,
        admit every queued request that fits, then advance all active rows
        with EXACTLY ONE mixed-progress decode step.  Returns False when
        fully idle.

        Failure isolation: an exception while admitting resolves THAT
        request to a ``RequestError``; one while growing fails only the
        rows that needed the larger bucket; one in the decode step fails
        the rows that shared it.  Nothing propagates out of ``step()``.
        """
        with trace.span("vx.sched.tick"):
            return self._tick()

    def _tick(self) -> bool:
        srv = self.server
        worked = self._retire_finished()
        worked |= self._expire_deadlines()
        while True:
            with self._lock:
                req = (
                    self._queue.pop(0)
                    if self._queue
                    and self._queue[0].tokens.shape[0]
                    <= len(self._free_slots())
                    else None
                )
            if req is None:
                break
            try:
                self._admit(req)
            except Exception as exc:
                assert req.request_id is not None
                self._fail_request(req.request_id, "admit", exc)
            worked = True
            # A stop token in the prefill argmax retires without a step.
            self._retire_finished()

        active = [
            (slot, row) for slot, row in enumerate(self.rows)
            if row is not None
        ]
        if not active:
            # Fully idle tick: donate one budgeted slice to the engine's
            # background calibrator (config.calibration="on-idle").  The
            # donation does NOT count as work: drain()'s termination
            # depends only on request progress.
            self._donate_idle_slice()
            return worked
        assert self.cache is not None

        needed = max(row.pos_next + 1 for _, row in active)
        if needed > self.kvb and self.kvb < srv.max_cache:
            try:
                self._grow(srv._grown_kv_bucket(self.kvb, needed))
            except Exception as exc:
                # Two-phase growth left the shared cache (and every lease)
                # untouched: fail exactly the rows that no longer fit.
                stuck = {
                    row.rid for _, row in active
                    if row.pos_next + 1 > self.kvb
                }
                for rid in stuck:
                    self._fail_request(rid, "grow", exc)
                return True

        # Free slots decode at pos 0: their k/v row 0 is written by this
        # very step (finite), and kv_len = 1 reads only it.
        tok = np.zeros((self.batch_rows, 1), np.int64)
        pos = np.zeros((self.batch_rows,), np.int32)
        for slot, row in active:
            tok[slot, 0] = row.last_tok
            pos[slot] = row.pos_next
        try:
            if faults.ACTIVE is not None:
                faults.ACTIVE.check("scheduler_step")
            dev = srv.device
            logits = srv.decode_vec(
                self.cache, torch.from_numpy(tok).to(dev),
                torch.from_numpy(pos).to(dev),
            )
            with trace.span("vx.sched.readback"):
                nxt = logits.argmax(-1).cpu().numpy()  # (batch_rows,)
        except Exception as exc:
            # Every row that shared this step resolves to a typed error.
            # Their cache rows may hold this step's k/v; the rows are freed,
            # and a slot's next occupant overwrites its rows before reading.
            for rid in {row.rid for _, row in active}:
                self._fail_request(rid, "decode", exc)
            return True
        self.stats["steps"] += 1
        self.stats["launches"] += 1  # the ONE decode step this tick made
        self.stats["rows_stepped"] += len(active)
        for slot, row in active:
            t = int(nxt[slot])
            row.out.append(t)
            row.last_tok = t
            row.pos_next += 1
            row.remaining -= 1
            if row.stop is not None and t == row.stop:
                row.remaining = 0
        return True

    def _donate_idle_slice(self) -> None:
        """With no queued request and no active row, give the engine's
        background calibrator one budgeted measurement slice (bounded by
        ``EngineConfig.calibration_budget_s``).  No-op when calibration is
        off or nothing is pending; never raises into the serving loop.
        The tick runs between decode steps, outside every graph capture."""
        cal = self.server.engine.calibrator
        if cal is None:
            return
        with self._lock:
            if self._queue:
                return
        try:
            if cal.pending():
                cal.run_slice()
                self.stats["calibration_slices"] += 1
        except Exception:
            logging.getLogger(__name__).exception(
                "idle calibration slice failed; serving goes on")

    def drain(self) -> dict[int, np.ndarray | RequestError]:
        """Run steps until queue and slots are empty; return (and clear)
        the results resolved since the last drain: a ``(b, max_new)`` token
        array per completed request, or the :class:`RequestError` that
        resolved it.  Failed requests free their slots at once, so drain
        terminates even when every step faults."""
        while True:
            worked = self.step()
            with self._lock:
                queued = bool(self._queue)
            if not worked and not queued and not any(self.rows):
                break
        with self._lock:
            out = self._results
            self._results = {}
        return out
