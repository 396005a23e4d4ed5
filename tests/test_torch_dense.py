"""The dense decoder family held against the JAX package.

gemma2 (local/global windows, attention and final softcaps, sqrt(d)
embedding scale, GeGLU), h2o-danube3 (every layer windowed, untied head),
phi4-mini (a GQA group of 3) and starcoder2 (LayerNorm, plain GELU, a GQA
group of 4) on their smoke configs at f32.  Weights cross from the
reference's ``init_params`` through numpy (``params_from_numpy``), so both
sides compute one function.

Tolerances, relative to the logit scale: 1e-4 for prefill and decode logits
(aten and XLA:CPU sum in different orders over 2-4 layers), for decode at
one position for the batch, at per-row positions, and through the
sliding-window slice (a 48-row cache, longer than twice the smoke window of
16, read at rows whose slice clips at both ends).  The plain attention at
head widths 120 (h2o-danube3) and 256 (gemma2) is held against the Pallas
kernel in interpret mode at 1e-5 (f32) and 2^-5 (bf16: the Pallas kernel
rounds the probabilities to bf16 before P V).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.kernels.attention import (  # noqa: E402
    flash_attention as pallas_attention,
)
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params_mod  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models.partitioning import make_rules  # noqa: E402

from repro_torch.kernels.attention import flash_attention  # noqa: E402
from repro_torch.models import params as port_params_mod  # noqa: E402
from repro_torch.models.model import forward  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.models.registry import (  # noqa: E402
    get_config,
    get_smoke_config,
)
from repro_torch.vortex import Engine  # noqa: E402

ARCHS = ("gemma2-9b", "h2o-danube-3-4b", "phi4-mini-3.8b", "starcoder2-15b")
TOL = 1e-4


def _pair(arch: str):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ref_cfg = dataclasses.replace(
        ref_registry.get_smoke_config(arch), dtype="float32"
    )
    return cfg, ref_cfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg, ref_cfg = _pair(request.param)
    ref_p = ref_params_mod.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, ref_p), "cpu"
    )
    rules = make_rules(
        make_host_mesh(), n_heads=ref_cfg.n_heads,
        n_kv_heads=ref_cfg.n_kv_heads,
    )
    return cfg, ref_cfg, params, ref_p, rules


def _close(out, ref, where):
    r = np.asarray(ref, np.float32)
    o = out.detach().float().numpy()
    assert o.shape == r.shape, where
    assert np.isfinite(o).all(), where
    err = float(np.abs(o - r).max())
    assert err <= TOL * max(float(np.abs(r).max()), 1.0), (where, err)


class _nullctx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_schema_matches_reference_leaf_for_leaf(arch, which):
    """Every leaf's path, shape, init and dtype equal the reference's
    ``model_schema`` (the fan-in axis too: these are dense, so no expert
    stacks differ)."""
    cfg = get_config(arch) if which == "CONFIG" else get_smoke_config(arch)
    ref_cfg = (ref_registry.get_config(arch) if which == "CONFIG"
               else ref_registry.get_smoke_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    port = port_params_mod._leaves(port_params_mod.model_schema(cfg))
    ref = ref_params_mod._leaves(ref_params_mod.model_schema(ref_cfg))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, d), (_, r) in zip(port, ref):
        assert (d.shape, d.init, d.dtype, d.scale_axis) == (
            r.shape, r.init, r.dtype, r.scale_axis), path
    assert port_params_mod.count_params(cfg) == sum(
        int(np.prod(r.shape)) for _, r in ref)


@pytest.mark.parametrize("served", [False, True], ids=["inline", "engine"])
def test_prefill_and_decode_logits_match_reference(model, served):
    """Prefill, then decode at one position for the batch, then at per-row
    positions [11, 47] of a 48-row cache: on windowed layers (window 16)
    the decode reads the window slice, clipped at row 0 for the first row
    and at the cache end for the second."""
    cfg, ref_cfg, params, ref_p, rules = model
    rng = np.random.default_rng(0)
    b, s, cache_len = 2, 10, 48
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    eng = Engine(hardware="tpu_v5e", device="cpu")
    ctx = eng.use if served else _nullctx
    r_logits, r_cache, _ = ref_model.forward(
        ref_cfg, rules, ref_p, jnp.asarray(toks), mode="prefill",
        cache_len=cache_len,
    )
    with ctx():
        logits, cache = forward(
            cfg, params, torch.from_numpy(toks).long(), mode="prefill",
            cache_len=cache_len,
        )
    _close(logits, r_logits, "prefill logits")
    for step, pos in enumerate((s, np.array([s + 1, cache_len - 1]))):
        nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        r_logits, r_cache, _ = ref_model.forward(
            ref_cfg, rules, ref_p, jnp.asarray(nxt), mode="decode",
            cache=r_cache, pos=jnp.asarray(pos, jnp.int32),
            cache_len=cache_len,
        )
        port_pos = pos if isinstance(pos, int) else torch.from_numpy(
            pos.astype(np.int32))
        with ctx():
            logits, cache = forward(
                cfg, params, torch.from_numpy(nxt).long(), mode="decode",
                cache=cache, pos=port_pos,
            )
        _close(logits, r_logits, f"decode logits, step {step} pos {pos}")
        for key in r_cache:
            _close(cache[key]["k"], r_cache[key]["k"], f"{key} k cache")
    if served:
        st = eng.stats()
        assert st["attention"]["launches"] == cfg.n_layers
        assert st["decode_attention"]["launches"] == 2 * cfg.n_layers
        assert st["decode_attention"]["padded_calls"] == 0


def test_per_row_positions_equal_one_position_per_row(model):
    """A (b,) ``pos`` whose rows all sit at one position is the scalar
    decode, bit for bit (the per-row cache write and window gather are the
    scalar ones row by row)."""
    cfg, _, params, _, _ = model
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 40))).long()
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1))).long()
    outs = []
    for pos in (40, torch.full((3,), 40, dtype=torch.int32)):
        _, cache = forward(cfg, params, toks, mode="prefill", cache_len=48)
        logits, cache = forward(cfg, params, nxt, mode="decode", cache=cache,
                                pos=pos)
        outs.append((logits, cache["pos0"]["k"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# (b, hq, hkv, sq, skv, d, block_q, block_k, window, softcap, kv_len, q_off)
WIDE_ATTN_CASES = {
    "danube_prefill_d120": (1, 4, 1, 24, 24, 120, 8, 8, 16, None, 24, None),
    "gemma2_prefill_d256": (1, 2, 1, 20, 20, 256, 8, 8, 8, 50.0, 20, None),
    "danube_decode_d120": (2, 4, 1, 1, 32, 120, 1, 8, 16, None, [32, 9],
                           [31, 8]),
    "gemma2_decode_d256": (2, 2, 1, 1, 24, 256, 1, 8, 8, 50.0, [24, 5],
                           [23, 4]),
}


@pytest.mark.parametrize("name", list(WIDE_ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_at_wide_heads_matches_pallas(name, dtype):
    (b, hq, hkv, sq, skv, d, bq, bk, window, softcap, kv_len,
     q_off) = WIDE_ATTN_CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    for i, n in enumerate(np.broadcast_to(np.asarray(kv_len), (b,))):
        k[i, :, n:] = np.nan  # garbage past each row's extent
        v[i, :, n:] = np.nan
    causal = sq > 1
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = pallas_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(kv_len, jnp.int32),
        None if q_off is None else jnp.asarray(q_off, jnp.int32),
        block_q=bq, block_k=bk, causal=causal, window=window,
        softcap=softcap, interpret=True,
    )
    tdt = getattr(torch, dtype)
    kv_t = kv_len if isinstance(kv_len, int) else torch.tensor(kv_len)
    off_t = None if q_off is None else torch.tensor(q_off)
    out = flash_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), kv_t, off_t, block_q=bq, block_k=bk,
        causal=causal, window=window, softcap=softcap,
    )
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    r = np.asarray(ref.astype(jnp.float32))
    o = out.float().numpy()
    assert np.isfinite(o).all()
    err = float(np.abs(o - r).max())
    assert err <= tol * max(float(np.abs(r).max()), 1.0), (name, err)
