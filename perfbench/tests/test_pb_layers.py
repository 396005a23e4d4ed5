"""Configuration files that state a layer pattern: weights, reference,
counts, the cut and the port's own records come from the file.  A file
without a pattern draws, counts and judges bit for bit as before
(``pb_frozen.py``)."""
import dataclasses
import json
import os
import time

import pytest
import torch

import pb_frozen as frozen
from kit import counts, judge, program_trace, serving, spec, weights
from kit.gemm_stream import GemmRun
from kit.runner import Context
from kit.serving import ServeRun
from reference import decoder, hybrid

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)

UNPATTERNED = ["granite-smoke", "phi4-smoke"]
PATTERNED = ["jamba-smoke", "deepseek-smoke", "falcon-mamba-smoke"]
# Both sides compute in float32 and differ only in the order of their
# sums (the port's chunked log-depth scan, its absorbed latent decode,
# its grouped expert slabs): ~3e-6 of the logits' scale at these sizes.
# 1e-4 leaves thirty times that; the float8 control misses it by more
# than a thousand times.
TOL = 1e-4


def _conf(name):
    path = os.path.join(HERE, "data", name + ".json")
    if not os.path.exists(path):
        path = os.path.join(PB, "configs", name + ".json")
    with open(path) as f:
        return json.load(f)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


# -- files without a pattern: as before ---------------------------------------

@pytest.mark.parametrize("name", UNPATTERNED + ["granite-moe-1b-a400m",
                                                 "phi4-mini-3.8b"])
def test_unpatterned_leaves_are_as_before(name):
    model = _conf(name)["model"]
    assert weights.leaves(model) == frozen.leaves(model)
    assert weights.nbytes(model) == frozen.nbytes(model)


@pytest.mark.parametrize("name", UNPATTERNED)
def test_unpatterned_draw_is_as_before(name):
    model = _conf(name)["model"]
    for seed in (7, 2147483693, 2 ** 33 + 5):
        got = _flat(weights.draw(model, seed, "cpu"))
        want = _flat(frozen.draw(model, seed, "cpu"))
        assert list(got) == list(want)
        for path in want:
            assert got[path].dtype == want[path].dtype
            assert torch.equal(got[path], want[path]), path


@pytest.mark.parametrize("name", UNPATTERNED + ["granite-moe-1b-a400m",
                                                 "phi4-mini-3.8b"])
def test_unpatterned_counts_are_as_before(name):
    model = _conf(name)["model"]
    gen = torch.Generator().manual_seed(5)
    assert counts.matmul_params_per_token(model) == \
        frozen.matmul_params_per_token(model)
    for _ in range(50):
        kv = torch.randint(1, 4097, (int(torch.randint(1, 33, (1,),
                                                        generator=gen)),),
                           generator=gen).tolist()
        s = int(torch.randint(1, 8193, (1,), generator=gen))
        assert counts.decode_attn_bound_s(model, kv) == \
            frozen.decode_attn_bound_s(model, kv)
        assert counts.prefill_attn_bound_s(model, s) == \
            frozen.prefill_attn_bound_s(model, s)
        assert counts.decode_flops(model, kv) == frozen.decode_flops(model, kv)
        assert counts.prefill_flops(model, s) == frozen.prefill_flops(model, s)
        assert counts.token_flops(model, s, head=False) == \
            frozen.token_flops(model, s, head=False)


@pytest.mark.parametrize("fmt", ["f32", "fp8"])
@pytest.mark.parametrize("name", UNPATTERNED)
def test_unpatterned_reference_is_as_before(name, fmt):
    conf = _conf(name)
    model = conf["model"]
    assert judge.reference_for(conf) is decoder
    ws = weights.draw(model, 11, "cpu")
    toks = torch.randint(0, model["vocab"], (30,),
                         generator=torch.Generator().manual_seed(2))
    got = decoder.logits(ws, model, toks, 9, 16, weight_fmt=fmt)
    want = frozen.logits(ws, model, toks, 9, 16, weight_fmt=fmt)
    assert torch.equal(got, want)


# -- files with a pattern -----------------------------------------------------

@pytest.mark.parametrize("name", PATTERNED)
def test_patterned_tree_is_the_ports(name):
    from repro_torch.models.params import abstract_params

    conf = _conf(name)
    cfg = serving.port_config(conf)
    serving.check_widths(cfg, conf["model"])
    want = _flat(abstract_params(cfg))
    got = _flat(weights.draw(conf["model"], 3, "cpu"))
    assert sorted(got) == sorted(want)
    for path, t in want.items():
        assert (got[path].shape, got[path].dtype) == (t.shape, t.dtype), path
    assert judge.reference_for(conf) is hybrid


def test_constant_leaves_are_the_ports():
    m = _conf("jamba-smoke")["model"]
    ws = weights.draw(m, 3, "cpu")
    mamba = ws["pos0"]["mamba"]
    assert torch.equal(mamba["A_log"][0, 5], torch.log(
        torch.arange(1, 9, dtype=torch.float64)).float())
    assert (mamba["D"] == 1).all() and (mamba["conv_b"] == 0).all()
    assert (mamba["dt_bias"] == 0).all()
    assert (ws["pos0"]["norm_mixer"] == 1).all()


def _f32(name):
    conf = _conf(name)
    model = dict(conf["model"], dtype="float32")
    cfg = dataclasses.replace(serving.port_config(conf), dtype="float32")
    return model, cfg, weights.draw(model, 7, "cpu")


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", PATTERNED)
def test_hybrid_reference_matches_port_at_every_prompt_position(name):
    from repro_torch.models.model import forward

    torch.set_num_threads(2)
    model, cfg, params = _f32(name)
    toks = torch.randint(0, model["vocab"], (40,),
                         generator=torch.Generator().manual_seed(3))
    logits, _ = forward(cfg, params, toks[None], mode="prefill",
                        cache_len=40)
    got = logits[0, :, :model["vocab"]]
    ref = hybrid.logits(params, model, toks, 40, 40, first=0)
    assert _gap(got, ref) < TOL
    low = hybrid.logits(params, model, toks, 40, 40, first=0,
                        weight_fmt="fp8")
    assert _gap(low, ref) > 1e3 * _gap(got, ref) and _gap(low, ref) > TOL


@pytest.mark.parametrize("name", PATTERNED)
def test_hybrid_reference_matches_port_prefill_and_mixed_decode(name):
    """Prompts padded to their bucket, then decode through the cache with
    the rows at mixed positions: Mamba's state past the pad, latent
    attention's absorbed decode."""
    from repro_torch.models.model import decode_step, prefill_step

    torch.set_num_threads(2)
    model, cfg, params = _f32(name)
    gen = torch.Generator().manual_seed(4)
    lens, sp, kvb, steps = [5, 11, 16], 16, 32, 4
    prompts = [torch.randint(0, model["vocab"], (s,), generator=gen)
               for s in lens]
    caches = []
    for p in prompts:
        toks = torch.zeros((1, sp), dtype=torch.int64)
        toks[0, :p.numel()] = p
        logits, cache, _ = prefill_step(cfg, params, toks, cache_len=kvb,
                                        last=p.numel() - 1)
        ref = hybrid.logits(params, model, p, p.numel(), sp)
        assert _gap(logits[0, :model["vocab"]], ref[0]) < TOL
        caches.append(cache)
    cache = {k: {n: torch.cat([c[k][n] for c in caches], dim=1)
                 for n in caches[0][k]} for k in caches[0]}
    fed = torch.randint(0, model["vocab"], (len(lens), steps), generator=gen)
    pos = torch.tensor(lens, dtype=torch.int32)
    outs = []
    for t in range(steps):
        logits, cache, _ = decode_step(cfg, params, cache, fed[:, t:t + 1],
                                       pos + t)
        outs.append(logits[:, :model["vocab"]])
    for i, p in enumerate(prompts):
        ref = hybrid.logits(params, model, torch.cat([p, fed[i]]),
                            p.numel(), sp)
        for t in range(steps):
            assert _gap(outs[t][i], ref[t + 1]) < TOL, (i, t)


def test_scan_in_blocks_is_the_token_by_token_recurrence():
    gen = torch.Generator().manual_seed(8)
    t, di, ds = 600, 6, 4  # more than two blocks of SCAN_BLOCK
    dt = torch.rand(t, di, generator=gen) * 0.1
    xc, B, C = (torch.randn(t, n, generator=gen) for n in (di, ds, ds))
    A = -torch.rand(di, ds, generator=gen)
    h = torch.zeros(di, ds)
    want = []
    for i in range(t):
        h = torch.exp(dt[i, :, None] * A) * h + \
            (dt[i] * xc[i])[:, None] * B[i][None, :]
        want.append(h @ C[i])
    got = hybrid._scan(dt, xc, B, C, A)
    assert torch.allclose(got, torch.stack(want), rtol=1e-5, atol=1e-6)


def test_hybrid_reference_routes_as_the_decoder():
    """On an attention-only MoE file the two references agree: the same
    routing, capacity and drops."""
    conf = _conf("granite-smoke")
    model = dict(conf["model"], dtype="float32",
                 moe=dict(conf["model"]["moe"], capacity_factor=0.5))
    ws = weights.draw(model, 5, "cpu")
    toks = torch.randint(0, model["vocab"], (24,),
                         generator=torch.Generator().manual_seed(6))
    a = decoder.logits(ws, model, toks, 12, 16)
    b = hybrid.logits(ws, model, toks, 12, 16)
    assert _gap(b, a) < TOL


def _jamba_f32(**model_changes):
    model = dict(_conf("jamba-smoke")["model"], dtype="float32")
    model.update(model_changes)
    ws = weights.draw(model, 9, "cpu")
    toks = torch.randint(0, model["vocab"], (24,),
                         generator=torch.Generator().manual_seed(10))
    return model, ws, toks


def test_attention_without_positions(monkeypatch):
    """``attn_rope: false`` is the same forward with the rotation left
    out."""
    torch.set_num_threads(2)
    model, ws, toks = _jamba_f32()
    rotated = hybrid.logits(ws, model, toks, 12, 16)
    bare = hybrid.logits(ws, dict(model, attn_rope=False), toks, 12, 16)
    assert _gap(bare, rotated) > 1e-3
    monkeypatch.setattr(hybrid, "rope", lambda x, theta: x)
    assert torch.equal(hybrid.logits(ws, model, toks, 12, 16), bare)


def test_mamba_inner_norms():
    """With ``inner_norms`` dt, B and C are normalised before the scan: a
    scale on their columns of ``x_proj`` moves nothing beyond rounding;
    without, it moves the logits."""
    torch.set_num_threads(2)
    model, _, toks = _jamba_f32()
    normed = dict(model, ssm=dict(model["ssm"], inner_norms=True))
    # The norms' weights (ones) beside the same bits of every other leaf.
    ws = weights.draw(normed, 9, "cpu")
    scaled = {**ws, "pos0": {**ws["pos0"], "mamba": dict(
        ws["pos0"]["mamba"], x_proj=ws["pos0"]["mamba"]["x_proj"] * 3.0)}}
    a = hybrid.logits(ws, normed, toks, 12, 16)
    assert _gap(hybrid.logits(scaled, normed, toks, 12, 16), a) < TOL
    assert _gap(a, hybrid.logits(ws, model, toks, 12, 16)) > 1e-3
    assert _gap(hybrid.logits(scaled, model, toks, 12, 16),
                hybrid.logits(ws, model, toks, 12, 16)) > 1e-3


NORMS = ("dt_norm", "b_norm", "c_norm")


def _period():
    with open(os.path.join(PB, "tools", "jamba2-mini-period.json")) as f:
        return json.load(f)


def _normed(model):
    return dict(model, ssm=dict(model["ssm"], inner_norms=True))


def _is_norm(path):
    return "/mamba/" in path and path.rsplit("/", 1)[-1] in NORMS


def _model(which):
    """The period file as published, the smoke file with inner norms, or
    a test file as it is."""
    if which == "jamba2-mini-period":
        return _period()["model"]
    if which == "jamba-smoke-normed":
        return _normed(_conf("jamba-smoke")["model"])
    return _conf(which)["model"]


@pytest.mark.parametrize("which", ["jamba2-mini-period",
                                   "jamba-smoke-normed"])
def test_inner_norm_leaves(which):
    """Where the file states inner norms, each Mamba position lists its
    norms' weights right after ``x_proj``: (G, dt_rank), (G, d_state) and
    (G, d_state) in the model's dtype, each a leaf of ones."""
    model = _model(which)
    s, dt = model["ssm"], model["dtype"]
    G = model["n_layers"] // len(model["pattern"])
    shapes = [(G, s["dt_rank"]), (G, s["d_state"]), (G, s["d_state"])]
    leaves = weights.leaves(model)
    paths = [p for p, *_ in leaves]
    mamba = [i for i, p in enumerate(model["pattern"])
             if p["mixer"] == "mamba"]
    assert len(mamba) == 7
    assert sum(_is_norm(p) for p in paths) == 3 * len(mamba)
    for i in mamba:
        at = paths.index(f"pos{i}/mamba/x_proj")
        assert leaves[at + 1:at + 4] == [
            (f"pos{i}/mamba/{n}", shape, dt, None)
            for n, shape in zip(NORMS, shapes)]
    if which == "jamba-smoke-normed":
        ws = weights.draw(model, 2147483693, "cpu")
        for i in mamba:
            for n, shape in zip(NORMS, shapes):
                t = ws[f"pos{i}"]["mamba"][n]
                assert t.shape == shape and t.dtype == torch.bfloat16
                assert (t == 1).all()


@pytest.mark.parametrize("which", ["jamba2-mini-period",
                                   "jamba-smoke-normed"] + PATTERNED)
def test_every_other_leaf_draws_as_before(which):
    """The norms' weights are constants and take no draws: every other
    leaf is listed, and drawn, as before they existed (``pb_frozen.py``).
    The period file's 26.6 GB are compared by their list alone; a draw
    is a function of that list and the seed."""
    model = _model(which)
    leaves = weights.leaves(model)
    assert [leaf for leaf in leaves if not _is_norm(leaf[0])] == \
        frozen.pattern_leaves(model)
    if which == "jamba2-mini-period":
        return
    for seed in (7, 2147483693, 2 ** 33 + 5):
        got = _flat(weights.draw(model, seed, "cpu"))
        want = _flat(frozen.pattern_draw(model, seed, "cpu"))
        assert [p for p in got if p not in want] == \
            [p for p in got if _is_norm(p)]
        for path in want:
            assert got[path].dtype == want[path].dtype
            assert torch.equal(got[path], want[path]), path


@pytest.mark.parametrize("fmt", ["f32", "fp8"])
def test_inner_norms_at_ones_judge_as_before(monkeypatch, fmt):
    """With the norms' weights at ones, the reference's logits are the
    bits it gave with unit norms of its own."""
    torch.set_num_threads(2)
    model = _model("jamba-smoke-normed")
    ws = weights.draw(model, 13, "cpu")
    toks = torch.randint(0, model["vocab"], (24,),
                         generator=torch.Generator().manual_seed(14))
    got = hybrid.logits(ws, model, toks, 12, 16, weight_fmt=fmt)
    monkeypatch.setattr(hybrid, "_mamba", frozen.hybrid_mamba)
    want = hybrid.logits(ws, model, toks, 12, 16, weight_fmt=fmt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("norm", NORMS)
def test_inner_norm_weights_move_the_logits(norm):
    """The reference reads the norms' weights: one position's, scaled,
    moves the logits."""
    torch.set_num_threads(2)
    model = _normed(dict(_conf("jamba-smoke")["model"], dtype="float32"))
    ws = weights.draw(model, 9, "cpu")
    toks = torch.randint(0, model["vocab"], (24,),
                         generator=torch.Generator().manual_seed(10))
    mamba = ws["pos1"]["mamba"]
    scaled = {**ws, "pos1": {**ws["pos1"], "mamba": dict(
        mamba, **{norm: mamba[norm] * 2.0})}}
    a = hybrid.logits(ws, model, toks, 12, 16)
    assert _gap(hybrid.logits(scaled, model, toks, 12, 16), a) > 1e-3


def test_dropless_experts():
    """``capacity_factor: null`` drops nothing: the prompt's group routes
    as under a capacity that holds every assignment."""
    torch.set_num_threads(2)
    model, ws, toks = _jamba_f32()
    moe = model["moe"]
    wide = hybrid.logits(ws, dict(model, moe=dict(moe, capacity_factor=100.0)),
                         toks, 12, 16)
    none = hybrid.logits(ws, dict(model, moe=dict(moe, capacity_factor=None)),
                         toks, 12, 16)
    tight = hybrid.logits(ws, dict(model, moe=dict(moe, capacity_factor=0.25)),
                          toks, 12, 16)
    assert torch.equal(none, wide)
    assert _gap(tight, wide) > 1e-3


@pytest.mark.parametrize("change", [
    {"attn_rope": False},
    {"ssm": {"d_inner": 128, "d_state": 8, "d_conv": 4, "dt_rank": 8,
             "inner_norms": True}},
    {"moe": {"num_experts": 4, "top_k": 2, "d_ff_expert": 128,
             "capacity_factor": None}},
], ids=["attn_rope", "inner_norms", "dropless"])
def test_widths_check_holds_the_port_to_published_kinds(change):
    """The port has RoPE, no inner norms and a capacity: a file that
    states otherwise stops the run."""
    conf = _conf("jamba-smoke")
    cfg = serving.port_config(conf)
    with pytest.raises(RuntimeError, match="differs"):
        serving.check_widths(cfg, dict(conf["model"], **change))


def _stating_kinds(cfg, positions, inner_norms, capacity_factor=1.25):
    """A stand-in for a port configuration that states its kinds: the
    port's own classes, frozen, with the two fields added
    (``kit/layout.py``)."""
    from repro_torch.models.config import ModelConfig, SSMSpec

    @dataclasses.dataclass(frozen=True)
    class Config(ModelConfig):
        positions: str = "rope"

    @dataclasses.dataclass(frozen=True)
    class SSM(SSMSpec):
        inner_norms: bool = False

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["ssm"] = SSM(**dataclasses.asdict(cfg.ssm),
                        inner_norms=inner_norms)
    fields["moe"] = dataclasses.replace(cfg.moe,
                                        capacity_factor=capacity_factor)
    return Config(**fields, positions=positions)


def test_widths_check_takes_the_kinds_the_port_states():
    """Where the port states no positional encoding, inner norms and
    dropless experts, the period file as published passes, and a copy
    that states the port's present kinds stops the run."""
    conf = _period()
    model = conf["model"]
    cfg = _stating_kinds(serving.port_config(conf), "none", True, None)
    serving.check_widths(cfg, model)
    ports = dict(model, attn_rope=True,
                 ssm=dict(model["ssm"], inner_norms=False),
                 moe=dict(model["moe"], capacity_factor=1.25))
    with pytest.raises(RuntimeError, match="differs") as e:
        serving.check_widths(cfg, ports)
    for key in ("attn_rope", "ssm", "moe"):
        assert f"'{key}'" in str(e.value)


@pytest.mark.parametrize("positions,attn_rope", [
    ("rope", True), ("sinusoidal", "sinusoidal"), ("none", False)])
def test_widths_check_reads_the_ports_positions(positions, attn_rope):
    """``positions`` is the file's ``attn_rope``: each kind passes the
    file that states it and no other."""
    conf = _conf("jamba-smoke")
    cfg = _stating_kinds(serving.port_config(conf), positions, False)
    for stated in (True, "sinusoidal", False):
        model = dict(conf["model"], attn_rope=stated)
        if stated is attn_rope:
            serving.check_widths(cfg, model)
        else:
            with pytest.raises(RuntimeError, match="'attn_rope'"):
                serving.check_widths(cfg, model)


@pytest.mark.parametrize("inner_norms", [True, False])
def test_widths_check_reads_the_ports_inner_norms(inner_norms):
    conf = _conf("jamba-smoke")
    cfg = _stating_kinds(serving.port_config(conf), "rope", inner_norms)
    for stated in (True, False, None):
        ssm = dict(conf["model"]["ssm"])
        if stated is not None:
            ssm["inner_norms"] = stated
        model = dict(conf["model"], ssm=ssm)
        if bool(stated) is inner_norms:
            serving.check_widths(cfg, model)
        else:
            with pytest.raises(RuntimeError, match="'ssm'"):
                serving.check_widths(cfg, model)


def _verdict(check, cfg, model):
    try:
        check(cfg, model)
    except RuntimeError as e:
        return str(e)
    return None


FILES = UNPATTERNED + PATTERNED + ["granite-moe-1b-a400m", "phi4-mini-3.8b",
                                   "jamba2-mini-period"]


@pytest.mark.parametrize("name", FILES)
def test_widths_verdicts_are_as_before(name):
    """Every port configuration that states neither field (each of the
    registry's, full and smoke, and the one each file names) gets from
    every file the verdict it got before the fields existed."""
    from repro_torch.models import registry

    conf = _period() if name == "jamba2-mini-period" else _conf(name)
    cfgs = [serving.port_config(conf)]
    for arch in registry.ARCH_IDS:
        cfgs += [registry.get_config(arch), registry.get_smoke_config(arch)]
    for cfg in cfgs:
        assert not hasattr(cfg, "positions")
        assert not hasattr(cfg.ssm, "inner_norms")
        assert _verdict(serving.check_widths, cfg, conf["model"]) == \
            _verdict(frozen.check_widths, cfg, conf["model"])
    # The period file states the published kinds, which no port
    # configuration has yet; each other file passes its own.
    own = _verdict(serving.check_widths, cfgs[0], conf["model"])
    assert (own is None) is (name != "jamba2-mini-period")


def test_counts_follow_the_pattern():
    """Hand-computed from the smoke files' widths."""
    j = _conf("jamba-smoke")["model"]
    # d 64; attention 64*16*(2*4 + 2*2) = 12,288; Mamba in_proj 64*256,
    # x_proj 128*(8 + 16), dt_proj 8*128, out_proj 128*64 = 28,672;
    # dense 3*64*128 = 24,576; MoE 2*3*64*128 + router 64*4 = 49,408.
    # One period: 7 Mamba, 1 attention, 4 dense, 4 MoE.
    params = 7 * 28672 + 12288 + 4 * 24576 + 4 * 49408
    assert counts.matmul_params_per_token(j) == params == 508928
    # Mamba's elementwise work: 128 channels * (2*4 conv + 4 + 7*8 scan).
    assert counts.mamba_token_flops(j) == 128 * 68
    head = 2 * 64 * 512
    assert counts.token_flops(j, 10, head=True) == \
        2 * params + 4 * 4 * 16 * 10 + 7 * 8704 + head
    assert counts.prefill_flops(j, 5) == \
        5 * 2 * params + 4 * 4 * 16 * 15 + 7 * 5 * 8704 + head
    # One attention layer of eight: n_layers times the share is its bound.
    one = counts.bound_s(4 * 4 * 16 * 3, 2 * (2 * 2 * 16 * 3 + 2 * 4 * 16))
    assert 8 * counts.decode_attn_bound_s(j, [3]) == pytest.approx(one)
    one = counts.bound_s(4 * 4 * 16 * 15, 2 * 5 * 16 * (2 * 4 + 2 * 2))
    assert 8 * counts.prefill_attn_bound_s(j, 5) == pytest.approx(one)

    d = _conf("deepseek-smoke")["model"]
    # MLA: wdq 64*48, wuq 48*4*24, wdkv 64*40, wuk 32*4*16, wuv 32*4*16,
    # wo 4*16*64 = 18,432; MoE 2*3*64*64 + router 64*8 + one shared
    # 3*64*64 = 37,376; two layers.
    params = 2 * (18432 + 37376)
    assert counts.matmul_params_per_token(d) == params == 111616
    # Absorbed decode per key 2*4*(2*32 + 8); naive prefill per pair
    # 2*4*(16 + 8 + 16).
    assert counts.token_flops(d, 10, head=True) == \
        2 * params + 2 * 576 * 10 + head
    assert counts.prefill_flops(d, 5) == 5 * 2 * params + 2 * 320 * 15 + head
    assert counts.decode_attn_bound_s(d, [3]) == 0.0

    f = _conf("falcon-mamba-smoke")["model"]
    params = 4 * 28672
    assert counts.matmul_params_per_token(f) == params
    assert counts.token_flops(f, 10, head=True) == \
        2 * params + 4 * 8704 + head
    assert counts.prefill_flops(f, 5) == 5 * 2 * params + 4 * 5 * 8704 + head


# -- the cut ------------------------------------------------------------------

def test_port_overrides_cut_the_depth():
    conf = dict(_conf("jamba-smoke"),
                reduced=["num_hidden_layers", "num_local_experts"],
                port_overrides={"n_layers": 16, "moe": {"num_experts": 8}})
    cfg = serving.port_config(conf)
    assert (cfg.n_layers, cfg.moe.num_experts, cfg.moe.top_k) == (16, 8, 2)
    model = dict(conf["model"], n_layers=16,
                 moe=dict(conf["model"]["moe"], num_experts=8))
    serving.check_widths(cfg, model)
    with pytest.raises(RuntimeError, match="differs"):
        serving.check_widths(cfg, conf["model"])


@pytest.mark.parametrize("name", ["num_experts", "num_local_experts",
                                  "n_routed_experts"])
def test_port_overrides_take_the_sources_names(name):
    conf = dict(_conf("jamba-smoke"), reduced=[name],
                port_overrides={"moe": {"num_experts": 8}})
    assert serving.port_config(conf).moe.num_experts == 8


@pytest.mark.parametrize("reduced", [[], ["n_layers"], ["moe"],
                                     ["vocab_size"]])
def test_port_overrides_need_reduced(reduced):
    conf = dict(_conf("jamba-smoke"), reduced=reduced,
                port_overrides={"n_layers": 16})
    with pytest.raises(RuntimeError, match=r"\['n_layers'\]"):
        serving.port_config(conf)


@pytest.mark.parametrize("over,reduced,refused", [
    ({"moe": {"top_k": 1}}, ["num_experts_per_tok", "moe", "num_experts"],
     "moe.top_k"),
    ({"moe": {"num_experts": 2, "d_ff_expert": 64}},
     ["num_experts", "moe", "moe_intermediate_size"], "moe.d_ff_expert"),
    ({"ssm": {"d_inner": 64}}, ["ssm", "mamba_expand"], "ssm.d_inner"),
    ({"vocab": 256}, ["vocab", "vocab_size"], "vocab"),
    ({"d_ff": 64}, ["d_ff", "intermediate_size"], "d_ff"),
], ids=["top_k", "d_ff_expert", "ssm", "vocab", "d_ff"])
def test_port_overrides_refuse_widths(over, reduced, refused):
    """Only the depth and the experts held may be cut: a width, nested or
    not, is refused whatever ``reduced`` lists."""
    conf = dict(_conf("jamba-smoke"), reduced=reduced, port_overrides=over)
    with pytest.raises(RuntimeError, match=rf"\['{refused}'\]"):
        serving.port_config(conf)


def test_one_period_of_jamba2_mini_is_the_ports_cut():
    """The sizing file of the hybrid reference's timing states one period
    of the published model: 8 of 32 layers cut from the port, every width
    as the port has it, and the port departs from it in exactly the
    three kinds the file lists under ``departures``."""
    with open(os.path.join(PB, "tools", "jamba2-mini-period.json")) as f:
        conf = json.load(f)
    cfg = serving.port_config(conf)
    assert cfg.n_layers == conf["num_hidden_layers"] == 8
    assert weights.nbytes(conf["model"]) == 26592948160
    model = conf["model"]
    with pytest.raises(RuntimeError, match="differs") as e:
        serving.check_widths(cfg, model)
    for key in ("attn_rope", "ssm", "moe"):
        assert f"'{key}'" in str(e.value)
    assert sorted(conf["departures"]) == [
        "attn_rope", "moe.capacity_factor", "ssm.inner_norms"]
    ports = dict(model, attn_rope=True,
                 ssm=dict(model["ssm"], inner_norms=False),
                 moe=dict(model["moe"], capacity_factor=1.25))
    serving.check_widths(cfg, ports)


@pytest.mark.parametrize("change", [
    {"pattern": [{"mixer": "mamba", "mlp": "moe"}] * 8},
    {"ssm": {"d_inner": 128, "d_state": 16, "d_conv": 4, "dt_rank": 8}},
    {"moe": {"num_experts": 4, "top_k": 2, "d_ff_expert": 128,
             "capacity_factor": 1.25, "num_shared": 1}},
    {"d_ff": 64},
], ids=["pattern", "ssm", "num_shared", "d_ff"])
def test_widths_check_reads_the_pattern(change):
    conf = _conf("jamba-smoke")
    cfg = serving.port_config(conf)
    serving.check_widths(cfg, conf["model"])
    with pytest.raises(RuntimeError, match="differs"):
        serving.check_widths(cfg, dict(conf["model"], **change))


def test_widths_check_refuses_a_pattern_on_an_attention_file():
    conf = _conf("phi4-smoke")
    cfg = serving.port_config(conf)
    serving.check_widths(cfg, conf["model"])
    with pytest.raises(RuntimeError, match="differs"):
        serving.check_widths(cfg, dict(
            conf["model"], pattern=[{"mixer": "mamba", "mlp": "dense"}]))


@pytest.mark.parametrize("name", PATTERNED + UNPATTERNED)
def test_patterned_file_reaches_the_port(name, monkeypatch):
    """The harness's own part of set-up: the weights drawn from the file,
    the widths checked, the server built on those weights.  Then what the
    port declares: where its scheduler does not serve the pattern, set-up
    stops at the scheduler's refusal before any warm-up request; where it
    does, a short run completes and is judged correct.  The files without
    a pattern take the second branch today."""
    from repro_torch.launch import scheduler, serve

    torch.set_num_threads(2)
    conf = _conf(name)
    with open(os.path.join(HERE, "data", "chat-smoke.json")) as f:
        mix = json.load(f)
    with open(os.path.join(HERE, "data", "serve-smoke-cell.json")) as f:
        cell = json.load(f)
    drawn, checked, built, submitted = [], [], [], []
    real_draw, real_check = weights.draw, serving.check_widths
    real_submit = scheduler.ContinuousScheduler.submit

    def draw(model, seed, device):
        drawn.append((model, seed, real_draw(model, seed, device)))
        return drawn[-1][2]

    def check(pcfg, model):
        real_check(pcfg, model)
        checked.append(model)

    class Server(serve.VortexServer):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            built.append(kw["params"])

    def submit(self, req):
        submitted.append(req)
        return real_submit(self, req)

    monkeypatch.setattr(weights, "draw", draw)
    monkeypatch.setattr(serving, "check_widths", check)
    monkeypatch.setattr(serve, "VortexServer", Server)
    monkeypatch.setattr(scheduler.ContinuousScheduler, "submit", submit)
    seed = 2147483701
    r = ServeRun(conf, cell, mix, seed=seed, seconds=2.0, trace=False,
                 device="cpu")
    if scheduler.batched_decode_supported(serving.port_config(conf)):
        r.setup()
        r.run()
        r.free()
        assert submitted
        numbers, _ = judge.serve_checks(r, seed, control=False)
        assert judge.verdict(judge.limited(numbers, cell["limits"])), numbers
    else:
        with pytest.raises(ValueError, match="continuous batching"):
            r.setup()
        assert submitted == []
    model, got_seed, tree = drawn[0]
    assert checked == [conf["model"]]
    assert model is conf["model"] and got_seed == seed
    assert sorted(_flat(tree)) == sorted(p for p, *_ in weights.leaves(model))
    assert len(built) == 1 and built[0] is tree


# -- the port's own records ---------------------------------------------------

class _FakeSlice:
    """Stands in for the profiler on the CPU."""

    def __init__(self):
        self.stopped = False

    def start(self):
        self.t_started = time.perf_counter()

    def stop(self):
        self.t_stopped = time.perf_counter()
        self.stopped = True

    def read(self):
        return None


@pytest.fixture
def no_profiler(monkeypatch):
    from kit import gemm_stream

    for mod in (serving, gemm_stream):
        monkeypatch.setattr(mod, "Slice", _FakeSlice)
        monkeypatch.setattr(mod, "warm_profiler", lambda: None)
    yield
    from repro_torch.runtime import trace

    trace.disable()


def _serve(cell_extra, traced, program=False):
    torch.set_num_threads(2)
    with open(os.path.join(HERE, "data", "chat-smoke.json")) as f:
        mix = json.load(f)
    with open(os.path.join(HERE, "data", "serve-smoke-cell.json")) as f:
        cell = dict(json.load(f), **cell_extra)
    r = ServeRun(_conf("phi4-smoke"), cell, mix, seed=2147483711,
                 seconds=2.0, trace=traced, device="cpu", program=program)
    r.setup()
    r.run()
    return r


def test_program_trace_in_a_traced_run(no_profiler):
    r = _serve({"trace_s": 0.3}, traced=True, program=True)
    ctx = Context(r, r.model, 0.0)
    p = ctx.program
    assert p is not None and r.trace is not None and r.trace.stopped
    names = {s[0] for s in p.window.spans}
    assert "vx.sched.tick" in names and "vx.serve.decode" in names
    for s in p.window.spans:
        assert r.t_window <= s[1] < r.t_close
    assert p.slice.spans and len(p.slice.spans) < len(p.window.spans)
    for s in p.slice.spans:
        assert r.trace.t_started <= s[1] < r.trace.t_stopped
    from repro_torch.runtime import trace

    assert trace.ACTIVE is None


def test_program_trace_stays_off(no_profiler, monkeypatch):
    from repro_torch.runtime import trace

    def refuse():
        raise AssertionError("trace.enable called")

    monkeypatch.setattr(trace, "enable", refuse)
    r = _serve({}, traced=True)
    assert program_trace.read(r) is None
    g = GemmRun(_conf("phi4-smoke"), {"trace_s": 0.2},
                _json_mix("gemm-smoke"), seed=3, seconds=0.5, trace=True,
                device="cpu")
    g.setup()
    g.run()
    assert Context(g, None, 0.0).program is None


def _metrics_dir(tmp_path, monkeypatch, readers):
    (tmp_path / "metrics").mkdir()
    for name, body in readers.items():
        (tmp_path / "metrics" / f"{name}.py").write_text(body)
    monkeypatch.setattr(spec, "HERE", str(tmp_path))


@pytest.mark.parametrize("declared,traced,on", [
    (True, True, True), (True, False, False), (False, True, False)],
    ids=["asked-traced", "asked-untraced", "not-asked"])
def test_a_reader_asks_for_the_program_trace(tmp_path, monkeypatch,
                                             declared, traced, on):
    """The tracer is on only in a traced run of a cell one of whose
    readers sets ``PROGRAM_TRACE``."""
    _metrics_dir(tmp_path, monkeypatch, {
        "plain": "def read(ctx):\n    return 1.0\n",
        "spans": ("PROGRAM_TRACE = %r\n" % declared
                  + "def read(ctx):\n    return None\n")})
    cell = spec.Cell(name="c", chips=1, conf={}, mix={}, settings={},
                     end_to_end=[], per_layer=[{"name": "plain"},
                                               {"name": "spans"}])
    assert spec.wants_program(cell, traced) is on


def test_no_accepted_reader_asks_for_the_program_trace():
    """The benchmark's own cells: their traced runs keep the tracer off."""
    with open(os.path.join(os.path.dirname(PB), "BENCHMARK.json")) as f:
        names = [w["name"] for w in json.load(f)["workloads"]]
    for name in names:
        cell = spec.load_cell(os.path.dirname(PB), name)
        assert spec.wants_program(cell, True) is False


def test_program_trace_in_a_traced_gemm_run(no_profiler):
    g = GemmRun(_conf("phi4-smoke"), {"trace_s": 0.2},
                _json_mix("gemm-smoke"), seed=3, seconds=0.6, trace=True,
                device="cpu", program=True)
    g.setup()
    g.run()
    p = Context(g, None, 0.0).program
    names = [s[0] for s in p.window.spans]
    # The window's calls, less those of its last round of shapes that
    # started after the close.
    n = names.count("vx.dispatch")
    assert len(g.calls) - len(g.shapes) <= n <= len(g.calls)
    assert p.slice is not None


def _json_mix(name):
    with open(os.path.join(HERE, "data", name + ".json")) as f:
        return json.load(f)


def test_records_between_renumbers():
    recs = program_trace.Records(
        spans=[("a", 1.0, 5.0, -1, None), ("b", 2.0, 3.0, 0, 7),
               ("c", 6.0, 7.0, -1, None)],
        replays=[("decode", 1, 2.5), ("decode", 2, 1.0), ("x", -1, None)],
        routing=[("prefill", 0, "counts")], spans_dropped=0,
        routing_dropped=0)
    part = recs.between(1.5, 6.5)
    assert part.spans == [("b", 2.0, 3.0, -1, 7), ("c", 6.0, 7.0, -1, None)]
    assert part.replays == [("decode", 0, 2.5), ("decode", 1, 1.0)]
    assert part.routing == []
