"""Serving cells: the port's ``ContinuousScheduler`` over ``VortexServer``,
driven from outside by an open or closed loop, timed at its boundaries.

Spans are the harness's own, taken around the two calls through which the
scheduler drives the server, wrapped on the instance:
``server.prefill`` (one admission; the first token is read back right
after it) and ``server.decode_vec`` (one batched step; every active row's
token is read back right after it).  Each wrapper synchronizes at its
end, which the scheduler's own read-back does a moment later anyway.  A
token's time is the end of the span that produced it.

Set-up draws the weights, builds the server and the scheduler with the
cell's public settings (``max_cache``, ``batch_rows``) and nothing else,
and runs a warm-up through the same scheduler that reaches every prompt
bucket the traffic can reach, capturing every prefill graph, and the
batched decode graph at every cache length the scheduler grows to,
before the window.

A seed-drawn share of the window's requests, and each one longer than
every request before it in the window, is tracked: at every decode step
that serves a tracked request, the decode wrapper keeps its row's logits
at a fixed seed-drawn set of vocabulary ids and at the token it serves
(the row's largest logit), for the comparison after the window.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time

import numpy as np
import torch

from kit import layout, program_trace
from kit import traffic as gen
from kit import weights
from kit.trace import Slice, warm_profiler

DRAIN_S = 60.0  # how long past the window's close answers are waited for
LOGIT_IDS = 1024  # vocabulary ids at which a tracked row's logits are kept


@dataclasses.dataclass
class Req:
    """One request of the window and what happened to it."""
    due: float  # seconds after the window's start (open loop)
    cls: str
    tokens: np.ndarray
    max_new: int
    rid: int | None = None
    prefill_start: float | None = None
    group_len: int | None = None  # the prompt's sequence bucket
    times: list = dataclasses.field(default_factory=list)
    out: np.ndarray | None = None
    error: str | None = None
    tracked: bool = False
    # A tracked request's kept logits, one (ids, served) pair per decode
    # step in order: the row at ``logit_ids`` and its largest value.
    kept: list = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[1])


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    rids: tuple
    kv_lens: tuple


@dataclasses.dataclass
class Prefill:
    t0: float
    t1: float
    prompt_len: int
    group_len: int


class ServeRun:
    """One run of a serving cell.  Times are ``time.perf_counter()``
    seconds; ``t_window`` is the window's start."""

    def __init__(self, conf: dict, cell: dict, mix: dict, seed: int,
                 seconds: float, trace: bool, rate: float | None = None,
                 device: str = "cuda", program: bool = False):
        self.conf, self.cell, self.mix = conf, cell, dict(mix)
        self.device = device
        if rate is not None:
            self.mix["rate_per_s"] = rate
        self.model = conf["model"]
        self.seed, self.seconds, self.trace_on = seed, seconds, trace
        self.reqs: list[Req] = []  # due in the window
        self.pre: list[Req] = []  # the pre-roll's, before the window
        self.steps: list[Step] = []
        self.prefills: list[Prefill] = []
        self.trace = None
        self.slice_steps = (0, 0)
        self.slice_prefills = (0, 0)
        self.t_window = self.t_close = self.t_end = 0.0
        self.overrun = False
        self.program = program  # the port's tracer on (kit/program_trace)
        self._track = np.random.default_rng(seed + 5)
        self._longest = -1
        self._tracked: set[int] = set()

    # -- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.launch.scheduler import ContinuousScheduler
        from repro_torch.launch.serve import VortexServer

        t0 = time.perf_counter()
        pcfg = port_config(self.conf)
        check_widths(pcfg, self.model)
        params = weights.draw(self.model, self.seed, self.device)
        sync(self.device)
        t1 = time.perf_counter()
        if self.program:
            program_trace.start()
        st = self.cell["server"]
        srv = VortexServer(pcfg, max_cache=st["max_cache"], params=params,
                           device=self.device)
        sched = ContinuousScheduler(srv, batch_rows=st["batch_rows"])
        vocab = self.model["vocab"]
        ids = np.random.default_rng(self.seed + 4).choice(
            vocab, size=min(LOGIT_IDS, vocab), replace=False)
        self.logit_ids = torch.as_tensor(np.sort(ids), device=self.device)
        self.srv, self.sched = srv, sched
        self._wrap()
        t2 = time.perf_counter()
        self._warm()
        self.setup_phases = {"weights": t1 - t0, "server": t2 - t1,
                             "warm": time.perf_counter() - t2}
        if self.trace_on:
            warm_profiler()

    def _wrap(self) -> None:
        srv, sched, dev = self.srv, self.sched, self.device
        real_prefill, real_decode = srv.prefill, srv.decode_vec

        def prefill(tokens):
            t0 = time.perf_counter()
            with torch.profiler.record_function("pb.prefill"):
                out = real_prefill(tokens)
                sync(dev)
            t1 = time.perf_counter()
            s = int(tokens.shape[1])
            self.prefills.append(Prefill(t0, t1, s, srv.seq_bucket(s)))
            return out

        def decode_vec(cache, tokens, pos):
            rows = [r for r in sched.rows if r is not None]
            t0 = time.perf_counter()
            with torch.profiler.record_function("pb.decode"):
                out = real_decode(cache, tokens, pos)
                sync(dev)
            t1 = time.perf_counter()
            self.steps.append(Step(t0, t1, tuple(r.rid for r in rows),
                                   tuple(r.pos_next + 1 for r in rows)))
            if self._tracked:
                self._keep(out)
            return out

        srv.prefill, srv.decode_vec = prefill, decode_vec

    def _keep(self, logits: torch.Tensor) -> None:
        """Keep each tracked row's logits of this step (the step's output
        buffer is the graph's, overwritten by the next replay)."""
        slots = [(i, r.rid) for i, r in enumerate(self.sched.rows)
                 if r is not None and r.rid in self._tracked]
        if not slots:
            return
        with torch.profiler.record_function("pb.keep"):
            idx = torch.as_tensor([i for i, _ in slots], device=self.device)
            rows = logits.index_select(0, idx)
            sub = rows.index_select(1, self.logit_ids).float()
            top = rows[:, :self.model["vocab"]].amax(-1).float()
        for k, (_, rid) in enumerate(slots):
            self._by_rid[rid].kept.append((sub[k], top[k]))

    def _prompt_range(self) -> tuple[int, int]:
        lo = min(c["prompt"]["min"] for c in self.mix["classes"])
        hi = max(c["prompt"]["max"] for c in self.mix["classes"])
        return lo, hi

    def _warm(self) -> None:
        """One request per prompt bucket the traffic reaches, in batches
        of the scheduler's rows, then a full batch of decode steps."""
        from repro_torch.launch.serve import Request

        srv, sched = self.srv, self.sched
        lo, hi = self._prompt_range()
        first, last = srv.seq_bucket(lo), srv.seq_bucket(hi)
        lens = []
        for b in srv.seq_buckets():
            if first <= b <= last:
                s = min(b, hi)
                if srv.seq_bucket(s) != b:
                    raise RuntimeError(f"no prompt length serves bucket {b}")
                lens.append(s)
        rng = np.random.default_rng(self.seed + 1)
        vocab = self.model["vocab"]
        for i in range(0, len(lens), sched.batch_rows):
            for s in lens[i:i + sched.batch_rows]:
                sched.submit(Request(
                    tokens=rng.integers(0, vocab, (1, s), dtype=np.int64),
                    max_new=4))
            bad = [r for r in sched.drain().values()
                   if not isinstance(r, np.ndarray)]
            if bad:
                raise RuntimeError(f"warm-up request failed: {bad[0]}")
        for _ in range(sched.batch_rows):
            sched.submit(Request(
                tokens=rng.integers(0, vocab, (1, lo), dtype=np.int64),
                max_new=8))
        sched.drain()
        sync(self.device)
        self._captures = self._graph_captures()
        self.steps.clear()
        self.prefills.clear()

    # -- the window -------------------------------------------------------

    def _trace_tick(self, now: float) -> None:
        """Start the traced slice at 40% of the window, stop it after
        ``trace_s`` once it holds a prefill, each at a scheduler
        iteration's boundary.  A slice that meets no prefill ends at the
        window's close: a closed loop admits a prefill only when a row
        frees, which some seeds leave out of a 2 s slice."""
        if not self.trace_on:
            return
        t_on = self.t_window + 0.4 * self.seconds
        if self.trace is None and now >= t_on:
            self.trace = Slice()
            self.trace.start()
            self.slice_steps = (len(self.steps), len(self.steps))
            self.slice_prefills = (len(self.prefills), len(self.prefills))
        elif (self.trace is not None and not self.trace.stopped
              and now >= self.trace.t_started + self.cell["trace_s"]
              and (len(self.prefills) > self.slice_prefills[0]
                   or now >= self.t_close)):
            self._stop_trace()

    def _stop_trace(self) -> None:
        self.trace.stop()
        self.slice_steps = (self.slice_steps[0], len(self.steps))
        self.slice_prefills = (self.slice_prefills[0], len(self.prefills))

    def _submit(self, r: Req, window: bool) -> None:
        from repro_torch.launch.serve import Request

        r.rid = self.sched.submit(Request(tokens=r.tokens,
                                          max_new=r.max_new))
        self._by_rid[r.rid] = r
        self._pending.append(r)
        if window:
            size = r.prompt_len + r.max_new
            share = self.cell.get("track_share", 1.0)
            if self._track.random() < share or size > self._longest:
                r.tracked = True
                self._tracked.add(r.rid)
            self._longest = max(self._longest, size)

    def _step(self) -> bool:
        with torch.profiler.record_function("pb.schedule"):
            return self.sched.step()

    def run(self) -> None:
        kind = self.mix["kind"]
        self._by_rid: dict[int, Req] = {}
        # Submitted and not yet admitted, in queue order.
        self._pending: collections.deque[Req] = collections.deque()
        self._seen_prefills = self._seen_steps = 0
        if kind == "open_loop":
            self._open_loop()
        elif kind == "closed_loop":
            self._closed_loop()
        else:
            raise ValueError(f"a serving cell cannot run {kind!r} traffic")
        if self.trace is not None and not self.trace.stopped:
            self._stop_trace()
        self._collect()

    def _open_loop(self) -> None:
        """The pre-roll's requests (``preroll_s``, the same mix from a
        seed of its own), then the window's, each submitted when due."""
        vocab, pre_s = self.model["vocab"], self.cell.get("preroll_s", 0.0)
        items = gen.open_loop(self.mix, self.seconds, vocab, self.seed)
        self.reqs = [Req(it.due, it.cls, it.tokens, it.max_new)
                     for it in items]
        pre = gen.open_loop(self.mix, pre_s, vocab, self.seed + 7) \
            if pre_s else []
        self.pre = [Req(it.due - pre_s, it.cls, it.tokens, it.max_new)
                    for it in pre]
        queue = self.pre + self.reqs
        t0 = self.t_window = time.perf_counter() + pre_s
        self.t_close = t0 + self.seconds
        limit = self.t_close + DRAIN_S
        i, n = 0, len(queue)
        while True:
            now = time.perf_counter()
            while i < n and t0 + queue[i].due <= now:
                self._submit(queue[i], queue[i].due >= 0)
                i += 1
            self._trace_tick(now)
            if self._step():
                self._note_tokens()
            elif i < n:
                with torch.profiler.record_function("pb.wait"):
                    time.sleep(max(0.0, min(
                        0.002, t0 + queue[i].due - time.perf_counter())))
            else:
                break
            if now > limit:
                self.overrun = True
                break
        self.t_end = time.perf_counter()

    def _closed_loop(self) -> None:
        """``clients`` callers from ``preroll_s`` before the window; each
        sends its next request when its last one completes, until the
        window closes."""
        clients, pre_s = self.mix["clients"], self.cell.get("preroll_s", 0.0)
        pool = gen.closed_loop(self.mix, 8 * clients * max(
            1, int(self.seconds + pre_s)), self.model["vocab"], self.seed)
        t0 = self.t_window = time.perf_counter() + pre_s
        self.t_close = t0 + self.seconds
        nxt = 0

        def send(now):
            nonlocal nxt
            it = pool[nxt % len(pool)]
            nxt += 1
            r = Req(now - t0, it.cls, it.tokens, it.max_new)
            (self.reqs if now >= t0 else self.pre).append(r)
            self._submit(r, now >= t0)

        now = time.perf_counter()
        for _ in range(clients):
            send(now)
        while True:
            now = time.perf_counter()
            if now >= self.t_close:
                break
            self._trace_tick(now)
            self._step()
            done = self._note_tokens()
            now = time.perf_counter()
            for _ in range(done):
                send(now)
        self.t_end = time.perf_counter()

    def _note_tokens(self) -> int:
        """Give each request its tokens' times from the spans recorded
        since the last call; returns how many requests completed."""
        done = 0
        # Admissions run in queue order, one prefill each.
        for p in self.prefills[self._seen_prefills:]:
            r = self._pending.popleft()
            r.prefill_start = p.t0
            r.group_len = p.group_len
            r.times.append(p.t1)
            done += len(r.times) == r.max_new
        self._seen_prefills = len(self.prefills)
        for st in self.steps[self._seen_steps:]:
            for rid in st.rids:
                r = self._by_rid[rid]
                r.times.append(st.t1)
                done += len(r.times) == r.max_new
        self._seen_steps = len(self.steps)
        return done

    def _graph_captures(self) -> int:
        st = self.srv.stats
        return st["prefill_graph_captures"] + st["decode_graph_captures"]

    def _collect(self) -> None:
        """Drain what is left (every request submitted in the window runs
        to its end) and file each answer or error."""
        if self.overrun:
            # Past the drain limit: what is left counts as never served.
            results = {}
        else:
            results = self.sched.drain()
            self._note_tokens()
        for rid, res in results.items():
            r = self._by_rid[rid]
            if isinstance(res, np.ndarray):
                r.out = res[0]
            else:
                r.error = str(res)
        self.t_end = max(self.t_end, time.perf_counter())
        # Graphs captured after set-up: 0 when set-up reached every shape.
        self.window_captures = self._graph_captures() - self._captures

    # -- after the window -------------------------------------------------

    def free(self) -> None:
        """Drop the program's state so the reference starts from an
        empty card (its own peak is not the program's)."""
        self.sched.close()
        del self.sched, self.srv
        gc.collect()
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


# The port's fields that a cut to one chip may change, each with the
# names a published config.json gives it: the depth and the experts held.
# Every other field is a width or a kind, which no cut changes.
CUTS = {
    "n_layers": ("num_hidden_layers",),
    "moe.num_experts": ("num_experts", "num_local_experts",
                        "n_routed_experts"),
}


def port_config(conf: dict):
    """The port's own configuration the file names (its smoke size where
    the file says so: the CPU tests' cells), with the file's
    ``port_overrides`` applied: a top-level field, or a field of the
    nested ``moe`` spec given as an object.  Only the fields of
    :data:`CUTS` may be overridden, each listed in the file's ``reduced``
    by one of its source's names, or the run stops."""
    from repro_torch.models.registry import get_config, get_smoke_config

    name = conf["port_config"]
    cfg = get_smoke_config(name) if conf.get("port_smoke") else \
        get_config(name)
    over = conf.get("port_overrides", {})
    keys = [f"{k}.{n}" if isinstance(v, dict) else k
            for k, v in over.items()
            for n in (v if isinstance(v, dict) else (None,))]
    reduced = set(conf.get("reduced", ()))
    refused = [k for k in keys if not reduced & set(CUTS.get(k, ()))]
    if refused:
        raise RuntimeError(
            f"port_overrides changes {refused}: only the depth and the "
            f"experts held may be cut, each listed in reduced by its "
            f"source's name ({CUTS})")
    fields = {k: dataclasses.replace(getattr(cfg, k), **v)
              if isinstance(v, dict) else v for k, v in over.items()}
    return dataclasses.replace(cfg, **fields) if fields else cfg


def check_widths(pcfg, model: dict) -> None:
    """The port's configuration has the widths and the layer pattern the
    file states (``kit/layout.py``: a file without ``pattern`` states one
    attention position, and no Mamba or MLA widths)."""
    pattern = []
    for spec in pcfg.pattern:
        p = {"mixer": spec.mixer, "mlp": spec.mlp}
        if spec.window is not None or spec.cross_attn:
            # Kinds a file cannot state: never equal to the file's.
            p.update(window=spec.window, cross_attn=spec.cross_attn)
        pattern.append(p)
    got = {
        "n_layers": pcfg.n_layers, "d_model": pcfg.d_model,
        "n_heads": pcfg.n_heads, "n_kv_heads": pcfg.n_kv_heads,
        "head_dim": pcfg.resolved_head_dim, "vocab": pcfg.vocab,
        "vocab_padded": pcfg.vocab_padded, "dtype": pcfg.dtype,
        "tie_embeddings": pcfg.tie_embeddings,
        "rope_theta": pcfg.rope_theta, "pattern": pattern,
        # The port's other positions (sinusoidal) a file cannot state.
        "attn_rope": True if pcfg.use_rope else "sinusoidal",
        "moe": None, "ssm": None, "mla": None,
    }
    want = dict(model, pattern=layout.pattern(model), ssm=model.get("ssm"),
                mla=model.get("mla"), moe=model.get("moe"),
                attn_rope=model.get("attn_rope", True))
    if pcfg.moe is not None:
        got["moe"] = {"num_experts": pcfg.moe.num_experts,
                      "top_k": pcfg.moe.top_k,
                      "d_ff_expert": pcfg.moe.d_ff_expert,
                      "capacity_factor": pcfg.moe.capacity_factor,
                      "num_shared": pcfg.moe.num_shared}
        if want["moe"]:
            want["moe"] = dict(want["moe"],
                               num_shared=layout.num_shared(model))
    if any(p["mlp"] == "dense" for p in pattern):
        got["d_ff"] = pcfg.d_ff
    if pcfg.ssm is not None:
        s = pcfg.ssm
        got["ssm"] = {"d_inner": s.d_inner, "d_state": s.d_state,
                      "d_conv": s.d_conv,
                      "dt_rank": s.dt_rank or pcfg.d_model // 16,
                      "inner_norms": False}
        if want["ssm"]:
            want["ssm"] = dict(want["ssm"], inner_norms=want["ssm"].get(
                "inner_norms", False))
    if pcfg.mla is not None:
        got["mla"] = dataclasses.asdict(pcfg.mla)
    bad = {k: (v, want.get(k)) for k, v in got.items() if want.get(k) != v}
    if bad:
        raise RuntimeError(f"the port's configuration differs from the "
                           f"file's: {bad}")
