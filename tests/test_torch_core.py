"""The port's strategy core held against the JAX package's, and the H100
spec's structure.

For the reference's hardware specs the port must reproduce the pipeline
EXACTLY: lattices (layers and child maps), scored l1 costs, selection-table
starts and entries, and ``select(m)`` for every m up to m_max — the same
numpy arithmetic on the same inputs, so equality, not a tolerance.  The
H100 spec has no reference; it gets structural checks.
"""
import dataclasses
import math

import numpy as np
import torch
import pytest

pytest.importorskip("jax")

import repro.core as ref_core  # noqa: E402
from repro.core.analyzer import HybridAnalyzer as RefAnalyzer  # noqa: E402
from repro.core.analyzer import TableProfiler as RefTable  # noqa: E402
from repro.core.candidates import generate_lattice as ref_lattice  # noqa: E402
from repro.core.selector import RuntimeSelector as RefSelector  # noqa: E402

from repro_torch.core import (  # noqa: E402
    H100_SXM,
    HOST_CPU,
    TPU_V5E,
    AttentionWorkload,
    DecodeAttentionWorkload,
    GemmWorkload,
    TableProfiler,
)
from repro_torch.core.analyzer import HybridAnalyzer  # noqa: E402
from repro_torch.core.candidates import generate_lattice  # noqa: E402
from repro_torch.core.selector import RuntimeSelector  # noqa: E402
from repro_torch.kernels.attention import (  # noqa: E402
    attention_smem_bytes,
    tensor_core_attention_plan,
)
from repro_torch.kernels.gemm import (  # noqa: E402
    SMEM_PER_BLOCK,
    gemm_smem_bytes,
    tensor_core_plan,
)

M_MAX = 300  # not tile-aligned on purpose

# (port workload, reference workload) pairs over the slice's kinds.
WLS = [
    (GemmWorkload(M=None, N=768, K=768),
     ref_core.GemmWorkload(M=None, N=768, K=768)),
    (GemmWorkload(M=None, N=64, K=64),
     ref_core.GemmWorkload(M=None, N=64, K=64)),
    (AttentionWorkload(seq=None, head_dim=64),
     ref_core.AttentionWorkload(seq=None, head_dim=64)),
    (AttentionWorkload(seq=None, head_dim=16, window=8, softcap=5.0),
     ref_core.AttentionWorkload(seq=None, head_dim=16, window=8, softcap=5.0)),
    (DecodeAttentionWorkload(seq=None, head_dim=64),
     ref_core.DecodeAttentionWorkload(seq=None, head_dim=64)),
]
WL_IDS = ["gemm768", "gemm64", "attn64", "attn16win", "decode64"]
HWS = [(TPU_V5E, ref_core.TPU_V5E), (HOST_CPU, ref_core.HOST_CPU)]


def _sel_key(s):
    return (
        s.bucket, s.strategy.tiles, s.strategy.backend, s.backend, s.grid,
        s.padded_m, s.predicted_cost,
    )


def _scored(hw, wl, analyzer_cls, profiler, lattice_fn):
    return {
        b: analyzer_cls(hw, wl, profiler=profiler, empirical_levels=(0, 1))
        .score(lattice_fn(hw, wl, b))
        for b in hw.backends
    }


def test_reference_specs_copied_field_for_field():
    for port, ref in HWS:
        assert port.name == ref.name
        assert port.native_tile == dict(ref.native_tile)
        assert dict(port.backends) == dict(ref.backends)
        assert port.link_bandwidth == ref.link_bandwidth
        assert port.min_utilization == ref.min_utilization
        for a, b in zip(port.levels, ref.levels, strict=True):
            assert (a.depth, a.name, a.parallel_units, a.capacity_bytes,
                    a.load_bandwidth, a.compute_flops) == (
                b.depth, b.name, b.parallel_units, b.capacity_bytes,
                b.load_bandwidth, b.compute_flops)


@pytest.mark.parametrize("hw_pair", HWS, ids=[h[0].name for h in HWS])
@pytest.mark.parametrize("wl_pair", WLS, ids=WL_IDS)
def test_lattices_and_l1_costs_identical(hw_pair, wl_pair):
    hw, rhw = hw_pair
    wl, rwl = wl_pair
    assert wl.lattice_key == rwl.lattice_key
    for backend in hw.backends:
        lat, rlat = generate_lattice(hw, wl, backend), ref_lattice(rhw, rwl, backend)
        assert lat.layers == rlat.layers
        assert dict(lat.children[1]) == dict(rlat.children[1])
    sc = _scored(hw, wl, HybridAnalyzer, TableProfiler(hw), generate_lattice)
    rsc = _scored(rhw, rwl, RefAnalyzer, RefTable(rhw), ref_lattice)
    for backend in hw.backends:
        np.testing.assert_array_equal(sc[backend].l1_tiles, rsc[backend].l1_tiles)
        np.testing.assert_array_equal(sc[backend].l1_costs, rsc[backend].l1_costs)
        assert sc[backend].best_l0 == rsc[backend].best_l0


@pytest.mark.parametrize("hw_pair", HWS, ids=[h[0].name for h in HWS])
@pytest.mark.parametrize("wl_pair", WLS, ids=WL_IDS)
def test_tables_and_every_selection_identical(hw_pair, wl_pair):
    hw, rhw = hw_pair
    wl, rwl = wl_pair
    sel = RuntimeSelector(
        hw, wl, _scored(hw, wl, HybridAnalyzer, TableProfiler(hw),
                        generate_lattice),
        table_m_max=M_MAX,
    )
    rsel = RefSelector(
        rhw, rwl, _scored(rhw, rwl, RefAnalyzer, RefTable(rhw), ref_lattice),
        table_m_max=M_MAX,
    )
    t, rt = sel.table, rsel.table
    assert t.starts == rt.starts
    assert [_sel_key(e) for e in t.entries] == [_sel_key(e) for e in rt.entries]
    for m in range(1, M_MAX + 1):
        assert _sel_key(sel.select(m)) == _sel_key(rsel.select(m)), m
    # Past the table: the argmin fallback and the doubling extension agree.
    for m in (M_MAX + 1, 2 * M_MAX + 7):
        assert _sel_key(sel.select(m)) == _sel_key(rsel.select(m)), m
    assert sel.buckets_upto(M_MAX) == rsel.buckets_upto(M_MAX)


# ---------------------------------------------------------------------------
# H100_SXM: structure (no reference exists)
# ---------------------------------------------------------------------------

H100_WLS = [
    GemmWorkload(M=None, N=768, K=768),
    GemmWorkload(M=None, N=3072, K=768),
    AttentionWorkload(seq=None, head_dim=64),
    AttentionWorkload(seq=None, head_dim=16),
]


@pytest.mark.parametrize("wl", H100_WLS, ids=["g768", "g3072", "a64", "a16"])
@pytest.mark.parametrize("backend", ["tensor_core", "cuda_core"])
def test_h100_lattice_fits_the_card(wl, backend):
    hw = H100_SXM
    lat = generate_lattice(hw, wl, backend)
    bm, bn, bk = hw.native_tile[backend]
    assert lat.l0 and lat.l1
    for m, n, k in lat.l0:
        assert m % bm == 0 and n % bn == 0 and k % bk == 0
    smem_cap = hw.level(1).capacity_bytes
    assert smem_cap == 232448
    for tile in lat.l1:
        bound = wl.l1_tile_bytes(tile)
        assert bound <= smem_cap
        m1, n1, k1 = tile
        # Every tile the lattice admits launches: the kernel's shared
        # memory never exceeds the priced footprint.
        if wl.kind == "gemm" and backend == "tensor_core":
            # The wgmma tile's launch plan (csrc/tc_tile.cuh) for every
            # tensor_core tile: it fits the priced footprint and a block,
            # with 1-4 warpgroups and the accumulator in registers.
            plan = tensor_core_plan(m1, n1, k1)
            assert plan.smem_bytes <= bound
            assert plan.smem_bytes <= SMEM_PER_BLOCK == smem_cap
            assert 1 <= plan.warpgroups <= 4
            assert plan.acc_per_thread <= 128
            assert plan.acc_per_thread * plan.threads == m1 * n1
            assert gemm_smem_bytes(m1, n1, k1) <= bound  # f32 at this tile
        elif wl.kind == "gemm":
            assert gemm_smem_bytes(m1, n1, k1) <= bound
        else:
            d = wl.head_dim
            assert attention_smem_bytes(m1, k1, d) <= bound
            assert attention_smem_bytes(1, k1, d) <= bound  # decode form
            if backend == "tensor_core":
                # The wgmma prefill kernel's plan (csrc/attention_tc.cu)
                # for every tensor_core tile: within the priced footprint
                # and a block, 1-4 warpgroups, and O plus S within half the
                # registers a thread gets at that block size.
                plan = tensor_core_attention_plan(m1, k1, d)
                assert plan.smem_bytes <= bound
                assert plan.smem_bytes <= SMEM_PER_BLOCK == smem_cap
                assert 1 <= plan.warpgroups <= 4
                assert plan.warpgroups * plan.rounds * 64 == m1
                assert plan.acc_per_thread <= min(
                    255, 65536 // plan.threads) // 2


def _h100_selection(wl, m, backend):
    """The H100 selector's pick at M, with its strategy moved to
    ``backend`` when it picked the other one."""
    hw = H100_SXM
    scored = _scored(hw, wl, HybridAnalyzer, TableProfiler(hw), generate_lattice)
    sel = RuntimeSelector(
        hw, wl, scored, num_cores=hw.level(2).parallel_units, table_m_max=256,
    ).select(m)
    if sel.strategy.backend != backend:
        tiles = generate_lattice(hw, wl, backend).l1
        strategy = dataclasses.replace(
            sel.strategy, tiles=(tiles[0],) * len(sel.strategy.tiles),
            backend=backend)
        sel = dataclasses.replace(sel, strategy=strategy, backend=backend)
    return sel


@pytest.mark.parametrize("backend", ["tensor_core", "cuda_core"])
@pytest.mark.parametrize("kind", ["gemm", "grouped_gemm", "conv2d",
                                  "attention", "decode_attention"])
def test_cuda_executables_pass_the_selected_backend(kind, backend,
                                                    monkeypatch):
    """The impl="cuda" executables hand ``sel.strategy.backend`` to the
    kernel wrapper with the tile (recorded here on CPU tensors)."""
    import repro_torch.kernels.attention as kattn
    import repro_torch.kernels.gemm as kgemm
    import repro_torch.kernels.grouped_gemm as kgrouped
    from repro_torch.core.workloads import (
        Conv2dWorkload,
        GroupedGemmWorkload,
    )

    calls = []

    def recorder(name):
        def fn(*args, block_m, block_n, block_k, backend):
            calls.append((name, (block_m, block_n, block_k), backend))
        return fn

    def attn_recorder(*args, block_q, block_k, backend, **masks):
        calls.append(("attention", (block_q, block_k), backend))

    monkeypatch.setattr(kgemm, "vortex_gemm", recorder("gemm"))
    monkeypatch.setattr(kgrouped, "vortex_grouped_gemm", recorder("grouped"))
    monkeypatch.setattr(kattn, "flash_attention", attn_recorder)
    if kind in ("attention", "decode_attention"):
        decode = kind == "decode_attention"
        wl = (DecodeAttentionWorkload if decode else AttentionWorkload)(
            seq=None, head_dim=16)
        sel = _h100_selection(wl, 64, backend)
        pq, _, pkv = sel.bucket
        m1, _, k1 = sel.strategy.l1
        q = torch.zeros(1, 2, 1 if decode else pq, 16)
        kv = torch.zeros(1, 2, pkv, 16)
        wl.build_executable(sel, impl="cuda")(q, kv, kv, pkv - 1)
        assert calls == [("attention", (1 if decode else m1, k1), backend)]
        return
    if kind == "gemm":
        wl, args = GemmWorkload(M=None, N=64, K=32), (
            torch.zeros(64, 32), torch.zeros(32, 64), 40)
    elif kind == "grouped_gemm":
        wl, args = GroupedGemmWorkload(C=None, G=4, E=2, N=64, K=32), (
            torch.zeros(4, 64, 32), torch.zeros(2, 32, 64),
            torch.zeros(4, dtype=torch.int32))
    else:
        wl = Conv2dWorkload(m=None, cin=4, cout=8, kh=3, kw=3)
        args = (torch.zeros(64, 36), torch.zeros(36, 8), 64)
    sel = _h100_selection(wl, 64, backend)
    wl.build_executable(sel, impl="cuda")(*args)
    assert calls == [(
        "grouped" if kind == "grouped_gemm" else "gemm", sel.strategy.l1,
        backend,
    )]


@pytest.mark.parametrize("wl", H100_WLS, ids=["g768", "g3072", "a64", "a16"])
def test_h100_both_backends_score_and_select(wl):
    hw = H100_SXM
    scored = _scored(hw, wl, HybridAnalyzer, TableProfiler(hw), generate_lattice)
    assert set(scored) == {"tensor_core", "cuda_core"}
    for sl in scored.values():
        assert sl.l1_costs.size and np.isfinite(sl.l1_costs).all()
        assert (sl.l1_costs > 0).all()
    sel = RuntimeSelector(
        hw, wl, scored, num_cores=hw.level(2).parallel_units, table_m_max=512,
    )
    for m in (1, 7, 64, 65, 200, 512):
        s = sel.select(m)
        assert s.padded_m >= m and s.padded_m % s.strategy.l1[0] == 0
        assert s.grid[0] == math.ceil(m / s.strategy.l1[0])
    assert hw.level(2).parallel_units == 132


@pytest.mark.parametrize("hw_pair", HWS, ids=[h[0].name for h in HWS])
@pytest.mark.parametrize("wl_pair", WLS[::2], ids=WL_IDS[::2])
def test_rkernel_programs_match_reference_structure(hw_pair, wl_pair):
    hw, rhw = hw_pair
    wl, rwl = wl_pair

    def shape(prog):
        return [
            (l.layer_depth, {a: t.value for a, t in l.loop_type.items()},
             l.analyzer.value, l.compute_func)
            for l in prog.layers
        ]

    prog, rprog = wl.program(hw), rwl.program(rhw)
    assert (prog.kind, prog.hardware, prog.depth) == (
        rprog.kind, rprog.hardware, rprog.depth)
    assert shape(prog) == shape(rprog)
