"""The port's MLA layer and the deepseek-v2 model and server held against
the JAX package, and what the three architectures of this slice
(deepseek-v2-236b, falcon-mamba-7b, jamba-v0.1-52b) share in the server.

The same weights (the reference's ``init_params``, carried over by
``params_from_numpy``) and the same numpy-seeded inputs go through
``repro.models.layers.mla_forward`` and the port's: the naive prefill
form, and the absorbed decode form at one position for the batch and at a
position per row.  The shared-expert branch of the MoE layer, the model's
prefill and decode, and the server's tokens and counters are held the
same way, at a no-drop capacity (``capacity_factor = num_experts``).

The server leases MLA's ``ckv``/``k_rope`` zeroed: the absorbed decode
multiplies masked rows by 0, so a stale NaN in a parked buffer would
reach the logits.  The kv-bucket source builds at every registered config
at full width on the H100 lattice (ROADMAP C12), and the six earlier
configs' bucket sets are pinned.  The scheduler refuses the three
architectures, and ``prefill="chained"`` falls back to ``"aot"``.

Tolerances, relative to the output scale, all at float32: 1e-5 for a
layer, 1e-4 for logits through a whole model.  Greedy tokens and the
servers' counters are identical.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import deepseek_v2_236b as ref_deepseek  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.scheduler import (  # noqa: E402
    ContinuousScheduler as RefScheduler,
)
from repro.launch.serve import Request as RefRequest  # noqa: E402
from repro.launch.serve import VortexServer as RefServer  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params_mod  # noqa: E402
from repro.models.partitioning import AxisRules, make_rules  # noqa: E402
from repro.models.registry import get_smoke_config as ref_smoke  # noqa: E402

from repro_torch.configs import deepseek_v2_236b  # noqa: E402
from repro_torch.launch.scheduler import ContinuousScheduler  # noqa: E402
from repro_torch.launch.serve import Request, VortexServer  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402
from repro_torch.models import params as params_mod  # noqa: E402
from repro_torch.models.registry import (  # noqa: E402
    ARCH_IDS,
    get_config,
    get_smoke_config,
)
from repro_torch.vortex import Engine  # noqa: E402

RULES = AxisRules(rules={}, mesh_axes=())
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "deepseek-v2-236b"
SLICE_ARCHS = ("deepseek-v2-236b", "falcon-mamba-7b", "jamba-v0.1-52b")


def _f32_no_drop(cfg):
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _close(out, ref, tol, where):
    o = np.asarray(out, np.float32)
    r = np.asarray(ref, np.float32)
    assert o.shape == r.shape, (where, o.shape, r.shape)
    err = float(np.abs(o - r).max())
    assert err <= tol * max(float(np.abs(r).max()), 1.0), (where, err)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model(arch=ARCH):
    """(port cfg, ref cfg, port params, ref params, rules) for the f32
    no-drop smoke config."""
    cfg = _f32_no_drop(get_smoke_config(arch))
    ref_cfg = _f32_no_drop(ref_smoke(arch))
    ref_p = ref_params_mod.init_params(ref_cfg, jax.random.PRNGKey(0))
    p = params_mod.params_from_numpy(cfg, _np(ref_p), "cpu")
    rules = make_rules(make_host_mesh(), n_heads=ref_cfg.n_heads,
                       n_kv_heads=ref_cfg.n_kv_heads)
    return cfg, ref_cfg, p, ref_p, rules


def _toks(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("size", ["CONFIG", "SMOKE"])
def test_schema_matches_reference_leaf_for_leaf(size):
    def defs(schema, leaves):
        return [(path, d.shape, d.dtype, d.init) for path, d in leaves(schema)]

    got = defs(params_mod.model_schema(getattr(deepseek_v2_236b, size)),
               params_mod._leaves)
    want = defs(ref_params_mod.model_schema(getattr(ref_deepseek, size)),
                ref_params_mod._leaves)
    assert got == want
    names = {p.rsplit("/", 1)[-1] for p, *_ in got}
    assert {"wdq", "wuq", "q_norm", "wdkv", "kv_norm", "wuk", "wuv",
            "shared_in", "shared_gate", "shared_out"} <= names
    for size_ in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(deepseek_v2_236b, size_)) == \
            dataclasses.asdict(getattr(ref_deepseek, size_))


def _mla_params():
    _, _, p, ref_p, _ = _model()
    return ({k: v[0] for k, v in p["pos0"]["mla"].items()},
            {k: v[0] for k, v in ref_p["pos0"]["mla"].items()})


def test_mla_prefill_matches_reference():
    cfg, ref_cfg, _, _, _ = _model()
    mp, ref_mp = _mla_params()
    s, cache_len = 21, 32
    x = np.random.default_rng(1).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    r_y, r_cache = ref_layers.mla_forward(
        ref_mp, jnp.asarray(x), ref_cfg, RULES, mode="prefill",
        positions=jnp.arange(s), cache_len=cache_len)
    y, cache = layers.mla_forward(
        mp, torch.from_numpy(x), cfg, mode="prefill",
        positions=torch.arange(s), cache_len=cache_len)
    _close(y.numpy(), r_y, LAYER_TOL, "prefill y")
    for name in ("ckv", "k_rope"):
        assert cache[name].shape == (2, cache_len, r_cache[name].shape[-1])
        _close(cache[name].numpy(), r_cache[name], LAYER_TOL, name)
        assert not cache[name][:, s:].any()  # zero-padded past s


@pytest.mark.parametrize("pos", [21, (21, 9)], ids=["scalar", "per_row"])
def test_mla_absorbed_decode_matches_reference(pos):
    cfg, ref_cfg, _, _, _ = _model()
    mp, ref_mp = _mla_params()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    _, r_cache = ref_layers.mla_forward(
        ref_mp, jnp.asarray(x), ref_cfg, RULES, mode="prefill",
        positions=jnp.arange(21), cache_len=32)
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos_np = np.asarray(pos, np.int32)
    r_y, r_new = ref_layers.mla_forward(
        ref_mp, jnp.asarray(xd), ref_cfg, RULES, mode="decode",
        cache=r_cache, pos=jnp.asarray(pos_np), cache_len=32)
    cache = {k: torch.from_numpy(np.array(v)) for k, v in r_cache.items()}
    pos_t = torch.from_numpy(np.broadcast_to(pos_np, (2,)).copy())
    y, new = layers.mla_forward(
        mp, torch.from_numpy(xd), cfg, mode="decode",
        positions=pos_t.reshape(2, 1), cache=cache, pos=pos_t)
    assert new is cache  # the new rows were written in place
    _close(y.numpy(), r_y, LAYER_TOL, "decode y")
    for name in ("ckv", "k_rope"):
        _close(cache[name].numpy(), r_new[name], LAYER_TOL, name)


@pytest.mark.parametrize("served", [False, True], ids=["inline", "engine"])
def test_shared_expert_branch_matches_reference(served):
    cfg, ref_cfg, _, _, _ = _model()
    assert cfg.moe.num_shared == 1
    rng = np.random.default_rng(3)
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_ff_expert
    shapes = {"router": (d, E), "w_in": (E, d, f), "w_gate": (E, d, f),
              "w_out": (E, f, d), "shared_in": (d, f), "shared_gate": (d, f),
              "shared_out": (f, d)}
    pn = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for k, s in shapes.items()}
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    r_y, _, r_drop = ref_layers.moe_forward(
        {k: jnp.asarray(v) for k, v in pn.items()}, jnp.asarray(x), ref_cfg,
        RULES)
    eng = Engine(hardware="tpu_v5e", device="cpu")
    pt = {k: torch.from_numpy(v) for k, v in pn.items()}
    if served:
        with eng.use():
            y, _, drop, _ = layers.moe_forward(pt, torch.from_numpy(x), cfg)
        assert eng.stats()["grouped_gemm"]["launches"] == 3
    else:
        y, _, drop, _ = layers.moe_forward(pt, torch.from_numpy(x), cfg)
    _close(y.numpy(), r_y, LAYER_TOL, "moe y")
    assert float(drop) == float(r_drop) == 0.0
    # The branch is not a no-op: without it the output moves.
    routed = {k: v for k, v in pt.items() if not k.startswith("shared")}
    y0, _, _, _ = layers.moe_forward(
        routed, torch.from_numpy(x),
        dataclasses.replace(cfg, moe=dataclasses.replace(m, num_shared=0)))
    assert float((y - y0).abs().max()) > 1e-2


def test_prefill_then_decode_matches_the_full_forward():
    """Mirrors tests/test_decode_consistency.py for deepseek-v2."""
    cfg, ref_cfg, p, ref_p, rules = _model()
    toks = _toks(cfg, 2, 35, 4)
    full, _, _ = ref_model.forward(ref_cfg, rules, ref_p, jnp.asarray(toks),
                                   mode="train")
    full = np.asarray(full)
    t = torch.from_numpy(toks).long()
    logits, cache = model.forward(cfg, p, t[:, :32], mode="prefill",
                                  cache_len=40)
    _close(logits.numpy(), full[:, :32], LOGIT_TOL, "prefill")
    for pos in range(32, 35):
        logits, cache = model.forward(cfg, p, t[:, pos:pos + 1],
                                      mode="decode", cache=cache, pos=pos)
        _close(logits[:, 0].numpy(), full[:, pos], LOGIT_TOL, f"pos {pos}")


def _server(arch=ARCH, max_cache=256, **kw):
    cfg, _, p, _, _ = _model(arch)
    return VortexServer(cfg, max_cache=max_cache, params=p, device="cpu",
                        hardware="tpu_v5e", **kw)


def test_tokens_and_counters_match_the_reference_server():
    """An aligned prompt, an unaligned one (the first token read at s - 1,
    ROADMAP C1: the JAX package's unpadded greedy decode) and one whose
    decode grows ckv/k_rope from kv bucket 128 to 256."""
    cfg, ref_cfg, _, ref_p, rules = _model()
    srv = _server()
    ref = RefServer(ref_cfg, make_host_mesh(), max_cache=256, seed=0)
    ref.params = ref_p
    for b, s, n in ((2, 16, 4), (1, 13, 4), (1, 125, 6)):
        toks = _toks(cfg, b, s, 200 + s)
        got = srv.generate(Request(tokens=toks, max_new=n))
        want = ref.generate(RefRequest(tokens=toks, max_new=n))
        if s == srv.seq_bucket(s):
            np.testing.assert_array_equal(got, want)
        else:
            logits, _, _ = ref_model.forward(
                ref_cfg, rules, ref_p, jnp.asarray(toks), mode="train")
            np.testing.assert_array_equal(
                got[:, 0], np.asarray(jnp.argmax(logits[:, -1], -1)))
    assert ref.stats == {
        "prefill_compiles": srv.stats["prefill_buckets"],
        "bucket_hits": srv.stats["bucket_hits"],
        "decode_compiles": srv.stats["decode_buckets"],
        "decode_bucket_hits": srv.stats["decode_bucket_hits"],
        "chained_prefills": srv.stats["chained_prefills"],
    }
    assert srv.decode_stats.as_dict() == ref.decode_stats.as_dict()
    assert srv.decode_stats.stage_copies == 2  # ckv and k_rope grew once
    assert srv.kv_pool.stats()["leases_active"] == 0


def _park_nan(srv, shape_of):
    """Lease one buffer of each ckv/k_rope leaf shape ``shape_of`` names,
    fill it with NaN and park it again."""
    for shape, dtype in shape_of:
        buf = srv.kv_pool.lease(shape, dtype, srv.device)
        buf.fill_(float("nan"))
        srv.kv_pool.release(buf)


def _stub_capture(monkeypatch):
    from repro_torch.launch import graphs

    class Graph:
        def __init__(self, fn, outputs):
            self.fn, self.outputs = fn, outputs

        def replay(self):
            for static, new in zip(self.outputs, self.fn()):
                static.copy_(new)

    def capture(fn, pool, stream):
        out = fn()
        return Graph(fn, out), out

    monkeypatch.setattr(graphs, "capture_graph", capture)


@pytest.mark.parametrize("where", ["growth", "graphed_prefill"])
def test_a_parked_nan_lease_serves_the_same_logits(where, monkeypatch):
    """A parked ckv/k_rope buffer full of NaN, leased by the cache's growth
    (graphs off) or by the prefill (graphs on, stub capture), serves the
    same logits as fresh zeros: the lease zeroes it in place."""
    cfg = _model()[0]
    graphs_on = where == "graphed_prefill"
    if graphs_on:
        _stub_capture(monkeypatch)
    srv = _server(graphs=graphs_on)
    fresh = _server(graphs=False)
    s = 125 if where == "growth" else 13
    toks = _toks(cfg, 2, s, 5)
    kvb = srv.kv_bucket(srv.seq_bucket(s))
    if where == "growth":
        kvb = srv._grown_kv_bucket(kvb, s + 4)
    spec = model.abstract_cache(cfg, 2, kvb)["pos0"]
    _park_nan(srv, [(t.shape, t.dtype) for t in spec.values()])
    outs = []
    for x in (srv, fresh):
        tok, cache, k = x.prefill(toks)
        pos, t = s - 1, tok[:, None]
        try:
            for _ in range(4):
                pos += 1
                if pos + 1 > k:
                    k = x._grown_kv_bucket(k, pos + 1)
                    cache = x._grow_cache(cache, k)
                logits = x._decode(cache, t, pos, x._decode_seen, k)
                t = logits.argmax(-1)[:, None]
                outs.append(logits)
        finally:
            x.release_cache(cache)
    assert srv.kv_pool.stats()["lease_hits"] == 2
    for a, b in zip(outs[:4], outs[4:]):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_scheduler_refuses_these_architectures(arch):
    cfg, ref_cfg, p, _, _ = _model(arch)
    srv = _server(arch, max_cache=64)
    with pytest.raises(ValueError) as got:
        ContinuousScheduler(srv)
    ref = RefServer(ref_cfg, make_host_mesh(), max_cache=64, seed=0)
    with pytest.raises(ValueError) as want:
        RefScheduler(ref)
    assert str(got.value) == str(want.value)
    assert "serial generate() path" in str(got.value)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_chained_prefill_falls_back_to_aot(arch):
    cfg = _model(arch)[0]
    chained = _server(arch, max_cache=64, prefill="chained")
    aot = _server(arch, max_cache=64)
    assert not chained._chained()
    req = Request(tokens=_toks(cfg, 2, 13, 6), max_new=4)
    np.testing.assert_array_equal(chained.generate(req), aot.generate(req))
    assert chained.stats["chained_prefills"] == 0
    assert chained.stats["prefill_buckets"] == 1


# ---------------------------------------------------------------------------
# ROADMAP C12: the kv-bucket source at full width on the H100 lattice
# ---------------------------------------------------------------------------

# The six earlier configs' sequence buckets up to 4096, kv buckets of
# (1, 63, 64, 65, 200, 1000, 4096) rows and decode buckets for prompts up
# to 512 with 64 new tokens (max_cache 4096), from the tree before the
# three architectures of this slice arrived.
PINNED_H100_BUCKETS = {
    "paper-gpt2-124m": (
        [64, 128, 192, 256, 320, 384, 512, 640, 768, 1024, 1280, 1536,
         2048, 2560, 2816, 3072, 3584, 4096],
        [64, 64, 64, 128, 256, 1024, 4096],
        [64, 128, 192, 256, 320, 384, 512, 640, 768, 1024]),
    "granite-moe-1b-a400m": (
        [64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 2560, 3072,
         3584, 4096],
        [64, 64, 64, 128, 256, 1024, 4096],
        [64, 128, 192, 256, 384, 512, 768, 1024]),
    "gemma2-9b": (
        [64, 128, 256, 512, 1024, 1536, 2048, 2560, 3072, 3584, 4096],
        [32, 64, 64, 96, 224, 1024, 4096],
        [64, 128, 256, 512, 1024]),
    "phi4-mini-3.8b": (
        [64, 128, 256, 512, 1024, 1280, 1536, 2048, 2560, 3072, 3584,
         4096],
        [32, 64, 64, 128, 256, 1024, 4096],
        [64, 128, 256, 512, 1024]),
    "h2o-danube-3-4b": (
        [64, 128, 256, 512, 1024, 1536, 2048, 2560, 3072, 3584, 4096],
        [32, 64, 64, 128, 256, 1024, 4096],
        [64, 128, 256, 512, 1024]),
    "starcoder2-15b": (
        [64, 128, 256, 512, 1024, 1536, 2048, 2560, 3072, 3584, 4096],
        [32, 64, 64, 128, 256, 1024, 4096],
        [64, 128, 256, 512, 1024]),
}


def _bucket_sets(arch):
    # ``params={}``: the bucket sources need no weights.
    srv = VortexServer(get_config(arch), max_cache=4096, params={},
                       device="cpu", hardware="h100_sxm")
    return (srv.seq_buckets(4096),
            [srv.kv_bucket(n) for n in (1, 63, 64, 65, 200, 1000, 4096)],
            srv.decode_buckets(m_max=512, max_new=64))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kv_bucket_source_builds_at_every_full_config(arch):
    seq, kv, dec = _bucket_sets(arch)
    assert seq and kv and dec
    assert all(b >= n for b, n in zip(kv, (1, 63, 64, 65, 200, 1000, 4096)))
    if arch in PINNED_H100_BUCKETS:
        assert (seq, kv, dec) == PINNED_H100_BUCKETS[arch]


def test_falcon_mamba_head_width_has_no_decode_lattice_on_the_h100():
    """Why C12 needed a repair: at falcon-mamba's resolved head_dim (its
    whole d_model, one head) no decode-attention tile fits a block's
    shared memory."""
    from repro_torch.core.workloads import DecodeAttentionWorkload

    cfg = get_config("falcon-mamba-7b")
    assert cfg.resolved_head_dim == 4096
    eng = Engine(hardware="h100_sxm", device="cpu")
    with pytest.raises(ValueError, match="no level-1 candidates"):
        eng.kernel_for(DecodeAttentionWorkload(
            seq=None, head_dim=cfg.resolved_head_dim)).bucket(64)
    srv = VortexServer(cfg, max_cache=4096, params={}, device="cpu",
                       hardware="h100_sxm")
    assert srv._decode_op.workload.head_dim == VortexServer.KV_BUCKET_HEAD_DIM
