"""The kernels' plain PyTorch versions held against the Pallas kernels.

The JAX side runs ``repro.kernels.gemm.vortex_gemm``,
``repro.kernels.attention.flash_attention`` and
``repro.kernels.grouped_gemm.vortex_grouped_gemm`` with ``interpret=True``,
as the JAX package's own tests do on the CPU (and ``repro.kernels.conv``'s
im2col and conv through XLA); the port's wrappers, given CPU tensors, run
their plain versions.  Inputs come from numpy with a seed.
Tolerances, relative to the output scale: float32 1e-5 (two f32
accumulation orders); bfloat16 GEMM and grouped GEMM 2^-7 (one bf16 ulp,
the rounding of the final cast); bfloat16 attention 2^-5 (the Pallas
kernel also rounds the probabilities to bf16 before the PV product, the
plain version keeps them in f32); im2col exact (it moves values).  Rows
past a grouped GEMM's count are exactly zero.  The hand-written CUDA
kernels are held
against the same plain versions on the card (the ``cuda``-marked case
here, and chip_smoke.py).
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import (
    attention_form,
    attention_path,
    check_attention_backend,
    decode_splits,
    flash_attention,
    flash_attention_plain,
    flash_decode_split_plain,
    tensor_core_attention_plan,
)
from repro_torch.kernels import build
from repro_torch.kernels.conv import conv_weight_matrix, im2col, vortex_conv2d
from repro_torch.kernels.gemm import (
    kernel_path,
    tensor_core_plan,
    vortex_gemm,
    vortex_gemm_plain,
)
from repro_torch.kernels.grouped_gemm import (
    vortex_grouped_gemm,
    vortex_grouped_gemm_plain,
)
from repro_torch.kernels.ref import ref_conv1d, ref_conv2d


def _oracle():
    """The JAX side, imported per test so this file also collects where
    jax is absent (the card's machine runs only the ``cuda`` case)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.attention import flash_attention as pallas_attention
    from repro.kernels.gemm import vortex_gemm as pallas_gemm

    return jnp, pallas_gemm, pallas_attention


TOL = {np.float32: 1e-5, "bfloat16": 2.0 ** -7}


def _close(out: torch.Tensor, ref, tol: float, where: str) -> None:
    o = out.float().numpy()
    r = np.asarray(ref, np.float32)
    assert o.shape == r.shape, where
    assert np.isfinite(o).all(), f"{where}: non-finite output"
    scale = max(float(np.abs(r).max()), 1.0)
    err = float(np.abs(o - r).max())
    assert err <= tol * scale, f"{where}: max|err| {err} > {tol} * {scale}"


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

GEMM_CASES = [
    # (M, N, K, m_true, bm, bn, bk): NaN tails past m_true, N/K tails that
    # do not divide the blocks.
    (48, 40, 24, 37, 16, 16, 16),
    (33, 50, 70, 20, 16, 32, 16),
    (64, 128, 128, 64, 32, 128, 128),
    (17, 8, 40, 1, 16, 8, 32),
]


@pytest.mark.parametrize("case", GEMM_CASES, ids=[str(c[:4]) for c in GEMM_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_plain_matches_pallas(case, dtype):
    jnp, pallas_gemm, _ = _oracle()
    M, N, K, m_true, bm, bn, bk = case
    rng = np.random.default_rng(M * 131 + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    a[m_true:] = np.nan  # the pad tail of a staged bucket buffer
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = pallas_gemm(
        jnp.asarray(a, jdt), jnp.asarray(b, jdt), m_true,
        block_m=bm, block_n=bn, block_k=bk, interpret=True,
    )
    tdt = getattr(torch, dtype)
    out = vortex_gemm(
        torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt), m_true,
        block_m=bm, block_n=bn, block_k=bk,
    )
    assert out.dtype == tdt
    assert (out[m_true:] == 0).all()  # rows past m_true are exactly zero
    _close(out, np.asarray(ref.astype(jnp.float32)),
           TOL[np.float32 if dtype == "float32" else "bfloat16"], str(case))


def test_gemm_rejects_degenerate_blocks():
    a, b = torch.zeros(4, 4), torch.zeros(4, 4)
    with pytest.raises(ValueError):
        vortex_gemm(a, b, block_m=0, block_n=8, block_k=8)


# (backend, block_m, block_n, block_k) pairs no kernel path can honour: an
# unknown backend, and tensor_core tiles off the (64, 8, 16) wgmma atom.
BAD_BACKEND_TILES = {
    "unknown_backend": ("mxu", 64, 8, 16),
    "tc_block_m_16": ("tensor_core", 16, 8, 16),
    "tc_block_n_12": ("tensor_core", 64, 12, 16),
    "tc_block_k_8": ("tensor_core", 64, 8, 8),
}


def _call_on_cpu(kernel, backend, bm, bn, bk, dtype=torch.bfloat16):
    if kernel == "gemm":
        a, b = torch.ones(70, 24, dtype=dtype), torch.ones(24, 40, dtype=dtype)
        return vortex_gemm(a, b, 65, block_m=bm, block_n=bn, block_k=bk,
                           backend=backend), vortex_gemm_plain(a, b, 65)
    if kernel == "grouped_gemm":
        x, w = torch.ones(4, 9, 24, dtype=dtype), torch.ones(2, 24, 40, dtype=dtype)
        counts = [9, 0, 3, 5]
        return vortex_grouped_gemm(
            x, w, counts, block_m=bm, block_n=bn, block_k=bk, backend=backend,
        ), vortex_grouped_gemm_plain(x, w, counts)
    x, w = torch.ones(1, 9, 9, 3, dtype=dtype), torch.ones(3, 3, 3, 8, dtype=dtype)
    cols, (b_, ho, wo) = im2col(x, 3, 3)
    return vortex_conv2d(x, w, block_m=bm, block_n=bn, block_k=bk,
                         backend=backend), \
        vortex_gemm_plain(cols, conv_weight_matrix(w)).reshape(b_, ho, wo, 8)


@pytest.mark.parametrize("kernel", ["gemm", "grouped_gemm", "conv2d"])
@pytest.mark.parametrize("bad", list(BAD_BACKEND_TILES))
def test_backend_and_tile_are_validated_before_the_cpu_branch(kernel, bad):
    backend, bm, bn, bk = BAD_BACKEND_TILES[bad]
    with pytest.raises(ValueError):
        _call_on_cpu(kernel, backend, bm, bn, bk)


@pytest.mark.parametrize("kernel", ["gemm", "grouped_gemm", "conv2d"])
@pytest.mark.parametrize("backend,tile", [
    ("tensor_core", (64, 8, 16)), ("tensor_core", (512, 32, 64)),
    ("cuda_core", (16, 12, 8)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_both_backends_run_the_plain_version_on_cpu(kernel, backend, tile, dtype):
    out, ref = _call_on_cpu(kernel, backend, *tile, dtype=getattr(torch, dtype))
    assert out.dtype == ref.dtype
    assert torch.equal(out, ref)


def test_kernel_path_is_fixed_by_backend_and_dtype():
    plan = tensor_core_plan(64, 8, 64)
    assert kernel_path(plan, torch.bfloat16) == "tensor_core"
    # Hopper has no exact f32 tensor-core product: f32 takes the FMA loop.
    assert kernel_path(plan, torch.float32) == "cuda_core"
    assert kernel_path(None, torch.bfloat16) == "cuda_core"
    assert kernel_path(None, torch.float32) == "cuda_core"


@pytest.mark.parametrize("tile,plan", [
    # (block_m, block_n, block_k) -> (wm, wn, n_atom, atoms, stages, smem)
    ((64, 8, 64), (1, 1, 8, 1, 2, 18432)),
    ((64, 16, 64), (1, 1, 16, 1, 2, 20480)),
    ((512, 32, 64), (4, 1, 32, 2, 2, 139264)),
    ((64, 512, 16), (1, 4, 128, 1, 4, 73728)),
    ((2048, 16, 16), (4, 1, 16, 8, 3, 198144)),
])
def test_tensor_core_plan_of_served_and_extreme_tiles(tile, plan):
    assert tuple(tensor_core_plan(*tile)) == plan


def test_tensor_core_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError):  # 96 accumulators of 64 x 8
        tensor_core_plan(64 * 12, 8, 16)
    with pytest.raises(ValueError):  # past a block's shared memory
        tensor_core_plan(64, 8, 4096)


def test_launch_counts_report_each_path_beside_the_totals():
    from repro_torch import kernels

    counts = kernels.launch_counts()
    for name in ("vortex_gemm", "vortex_grouped_gemm"):
        assert {name, f"{name}.tensor_core", f"{name}.cuda_core"} <= set(counts)
    # The plain versions on the CPU launch nothing.
    kernels.reset_launch_counts()
    vortex_gemm(torch.ones(64, 16, dtype=torch.bfloat16),
                torch.ones(16, 8, dtype=torch.bfloat16), block_m=64,
                block_n=8, block_k=16, backend="tensor_core")
    assert set(kernels.launch_counts().values()) == {0}


def test_build_digest_changes_when_a_header_changes(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc,
                    ignore=shutil.ignore_patterns("_build"))
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a device header"
    before = build.source_digest()
    assert build.source_digest() == before
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    assert build.source_digest() != before


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

# (b, hq, hkv, sq, skv, d, bq, bk, causal, window, softcap, kv_len, q_offset)
ATTN_CASES = {
    "causal": (2, 4, 4, 40, 40, 16, 16, 16, True, None, None, 33, None),
    "noncausal_gqa": (2, 4, 2, 24, 24, 16, 8, 16, False, None, None, 20, None),
    "window": (1, 2, 2, 32, 32, 16, 16, 8, True, 5, None, 32, None),
    "softcap": (1, 2, 1, 24, 24, 16, 8, 8, True, None, 4.0, 19, None),
    "per_row_kv_zero": (3, 2, 2, 16, 24, 16, 16, 8, False, None, None,
                        [24, 0, 9], None),
    "decode_offset": (3, 4, 2, 1, 32, 16, 1, 16, False, None, None,
                      [17, 32, 0], [16, 31, -1]),
    "decode_scalar": (2, 4, 4, 1, 48, 64, 1, 16, False, None, None, 30, 29),
}


def _attn_inputs(case, seed):
    b, hq, hkv, sq, skv, d = case[:6]
    kv_len = case[11]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    lens = np.broadcast_to(np.asarray(kv_len), (b,))
    for i, n in enumerate(lens):  # garbage past each row's extent
        k[i, :, n:] = np.nan
        v[i, :, n:] = np.nan
    return q, k, v


@pytest.mark.parametrize("name", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas(name, dtype):
    jnp, _, pallas_attention = _oracle()
    case = ATTN_CASES[name]
    (b, hq, hkv, sq, skv, d, bq, bk, causal, window, softcap, kv_len,
     q_off) = case
    q, k, v = _attn_inputs(case, seed=len(name))
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
    off_t = q_off if q_off is None or isinstance(q_off, int) \
        else torch.tensor(q_off)
    out = flash_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), kv_t, off_t, block_q=bq, block_k=bk,
        causal=causal, window=window, softcap=softcap,
    )
    assert out.dtype == tdt
    lens = np.broadcast_to(np.asarray(kv_len), (b,))
    for i, n in enumerate(lens):
        if n == 0:  # a kv_len == 0 row is exactly zero on both sides
            assert (out[i] == 0).all()
            assert (np.asarray(ref[i].astype(jnp.float32)) == 0).all()
    tol = TOL[np.float32] if dtype == "float32" else 4 * TOL["bfloat16"]
    _close(out, np.asarray(ref.astype(jnp.float32)), tol, name)


def test_attention_rejects_mismatched_heads():
    q = torch.zeros(1, 3, 4, 8)
    kv = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv)


# (backend, sq, block_q, block_k, head_dim) that no attention kernel path can
# honour: an unknown backend, and tensor_core prefill tiles off wgmma's (64
# rows, 16 keys), head widths off 8 or past 256, or past a block's shared
# memory.
BAD_ATTN_BACKEND_TILES = {
    "unknown_backend": ("mxu", 64, 64, 64, 64),
    "unknown_backend_decode": ("mxu", 1, 1, 64, 64),
    "tc_block_q_32": ("tensor_core", 64, 32, 64, 64),
    "tc_block_k_8": ("tensor_core", 64, 64, 8, 64),
    "tc_head_dim_20": ("tensor_core", 64, 64, 64, 20),
    "tc_head_dim_272": ("tensor_core", 64, 64, 16, 272),
    "tc_past_shared_memory": ("tensor_core", 64, 64, 1024, 64),
}


@pytest.mark.parametrize("bad", list(BAD_ATTN_BACKEND_TILES))
def test_attention_backend_and_tile_are_validated_before_the_cpu_branch(bad):
    backend, sq, bq, bk, d = BAD_ATTN_BACKEND_TILES[bad]
    q = torch.ones(1, 2, sq, d, dtype=torch.bfloat16)
    kv = torch.ones(1, 2, 64, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv, block_q=bq, block_k=bk, backend=backend)


@pytest.mark.parametrize("backend,sq,bq,bk,d", [
    ("tensor_core", 40, 64, 16, 16), ("tensor_core", 70, 128, 64, 64),
    ("cuda_core", 40, 16, 8, 24), ("tensor_core", 1, 1, 8, 24),
    ("cuda_core", 1, 1, 64, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_backends_run_the_plain_version_on_cpu(backend, sq, bq, bk,
                                                         d, dtype):
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(sq)
    q = torch.randn(2, 4, sq, d, generator=g).to(tdt)
    k, v = (torch.randn(2, 2, 64, d, generator=g).to(tdt) for _ in range(2))
    out = flash_attention(q, k, v, 50, 49 if sq == 1 else None, block_q=bq,
                          block_k=bk, backend=backend, causal=sq > 1)
    ref = flash_attention_plain(q, k, v, 50, 49 if sq == 1 else None,
                                causal=sq > 1)
    assert out.dtype == tdt
    assert torch.equal(out, ref)


def test_attention_path_is_fixed_by_form_backend_and_dtype():
    assert attention_form(1, 1) == "decode"
    assert attention_form(1, 64) == "prefill"  # one row of a prefill tile
    assert attention_form(64, 64) == "prefill"
    plan = check_attention_backend("prefill", "tensor_core", 64, 64, 64)
    assert plan is not None
    assert attention_path("prefill", plan, torch.bfloat16) == \
        "prefill.tensor_core"
    # Hopper has no exact f32 tensor-core product: f32 takes the FMA loop.
    assert attention_path("prefill", plan, torch.float32) == \
        "prefill.cuda_core"
    cuda = check_attention_backend("prefill", "cuda_core", 64, 64, 64)
    assert cuda is None
    assert attention_path("prefill", cuda, torch.bfloat16) == \
        "prefill.cuda_core"
    # Decode takes the split-kv kernel at both backends and dtypes.
    for backend in ("tensor_core", "cuda_core"):
        dplan = check_attention_backend("decode", backend, 1, 8, 24)
        assert dplan is None
        for dt in (torch.bfloat16, torch.float32):
            assert attention_path("decode", dplan, dt) == "decode.split_kv"


@pytest.mark.parametrize("tile,plan", [
    # (block_q, block_k, head_dim) -> (warpgroups, rounds, smem, acc)
    ((64, 64, 64), (1, 1, 40960, 64)),
    ((128, 128, 64), (2, 1, 81920, 64)),
    ((256, 64, 64), (4, 1, 65536, 64)),
    ((1024, 16, 16), (4, 4, 10240, 40)),
    ((64, 512, 16), (1, 1, 67584, 40)),
    ((128, 64, 128), (2, 1, 98304, 96)),
    ((256, 32, 256), (1, 4, 98304, 160)),
    # Head widths off k16 (ROADMAP C3): Q and K tiles padded to 16, V not.
    ((64, 64, 120), (1, 1, 79872, 92)),    # h2o-danube3
    ((128, 64, 120), (2, 1, 96256, 92)),
    ((64, 16, 24), (1, 1, 7680, 44)),
])
def test_tensor_core_attention_plan_of_served_and_extreme_tiles(tile, plan):
    assert tuple(tensor_core_attention_plan(*tile)) == plan


@pytest.mark.parametrize("rows,kv,bk,want", [
    (96, 71, 64, (64, 2)),      # paper-gpt2's decode: 192 CTAs
    (64, 71, 64, (64, 2)),      # granite's 8 rows x 8 kv heads
    (8, 32768, 64, (1984, 17)),  # a long cache: whole blocks a split
    (4, 0, 16, (16, 1)),        # no valid key: one split
    (200, 4096, 128, (4096, 1)),  # the rows alone fill the card
])
def test_decode_splits_cover_the_card_in_whole_blocks(rows, kv, bk, want):
    keys, n = decode_splits(rows, kv, bk, 132)
    assert (keys, n) == want
    assert keys % bk == 0 and (n - 1) * keys < max(kv, 1) <= n * keys


def test_attention_launch_counts_report_each_path_beside_the_totals():
    from repro_torch import kernels

    counts = kernels.launch_counts()
    assert {"flash_attention_prefill", "flash_attention_decode",
            "flash_attention_prefill.tensor_core",
            "flash_attention_prefill.cuda_core",
            "flash_attention_decode.split_kv"} <= set(counts)
    # The plain versions on the CPU launch nothing.
    kernels.reset_launch_counts()
    q = torch.ones(1, 2, 64, 64, dtype=torch.bfloat16)
    flash_attention(q, q, q, block_q=64, block_k=64, backend="tensor_core")
    flash_attention(q[:, :, :1], q, q, 64, 63, block_q=1, block_k=64,
                    backend="tensor_core", causal=False)
    assert set(kernels.launch_counts().values()) == {0}


# (b, hq, hkv, skv, d, split, window, kv_len, q_offset): one query row.
SPLIT_CASES = {
    # kv_len 0 (an exactly-zero row) and splits wholly past kv_len.
    "kv0_and_splits_past_kv_len": (3, 4, 4, 64, 16, 16, None, [40, 0, 9],
                                   [39, -1, 8]),
    "window": (2, 4, 2, 80, 16, 16, 6, [70, 33], [69, 32]),
    "per_row_offset_window": (2, 2, 1, 48, 16, 8, 20, [48, 48], [30, 47]),
    "gqa_16_8": (2, 16, 8, 64, 16, 32, None, [50, 1], [49, 0]),
    "scalar_kv_len": (2, 4, 4, 96, 16, 32, None, 30, 29),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_kv_plain_matches_reference_and_pallas(name, dtype):
    jnp, _, pallas_attention = _oracle()
    b, hq, hkv, skv, d, split, window, kv_len, q_off = SPLIT_CASES[name]
    case = (b, hq, hkv, 1, skv, d, 1, split, False, window, None, kv_len,
            q_off)
    q, k, v = _attn_inputs(case, seed=len(name))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pallas = pallas_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(kv_len, jnp.int32), jnp.asarray(q_off, jnp.int32),
        block_q=1, block_k=split, causal=False, window=window,
        interpret=True,
    )
    tdt = getattr(torch, dtype)
    kv_t = kv_len if isinstance(kv_len, int) else torch.tensor(kv_len)
    off_t = q_off if isinstance(q_off, int) else torch.tensor(q_off)
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    out = flash_decode_split_plain(qt, kt, vt, kv_t, off_t, split,
                                   causal=False, window=window)
    assert out.dtype == tdt and torch.isfinite(out.float()).all()
    for i, n in enumerate(np.broadcast_to(np.asarray(kv_len), (b,))):
        if n == 0:  # exactly zero on both sides
            assert (out[i] == 0).all()
            assert (np.asarray(pallas[i].astype(jnp.float32)) == 0).all()
    ref = flash_attention_plain(qt, kt, vt, kv_t, off_t, causal=False,
                                window=window)
    tol = TOL[np.float32] if dtype == "float32" else 4 * TOL["bfloat16"]
    _close(out, ref.float().numpy(), tol, f"{name} vs ref_attention")
    _close(out, np.asarray(pallas.astype(jnp.float32)), tol,
           f"{name} vs Pallas")


# ---------------------------------------------------------------------------
# Grouped GEMM
# ---------------------------------------------------------------------------

GROUPED_CASES = {
    # (G, E, C, K, N, counts, bm, bn, bk): counts of 0, partial and C, NaN
    # past each count, K/N tails that do not divide the blocks.
    "r1": (3, 3, 20, 24, 40, [0, 7, 20], 8, 16, 16),
    "r2_tails": (4, 2, 17, 70, 50, [17, 0, 5, 16], 16, 32, 16),
    "r4": (8, 2, 9, 32, 24, [9, 1, 0, 9, 3, 8, 0, 2], 8, 8, 32),
}


# The same kinds of case at tensor_core tiles (multiples of (64, 8, 16)): a
# NaN tail inside a 64-row atom, ragged K/N, the largest accumulator.
TC_GEMM_CASES = [
    (100, 96, 80, 77, 64, 64, 32),
    (33, 50, 70, 33, 64, 8, 16),
    (130, 1024, 64, 129, 64, 512, 16),
    (700, 64, 576, 650, 512, 32, 64),
]
TC_GROUPED_CASES = {
    "tc_r2_tails": (4, 2, 17, 70, 50, [17, 0, 5, 16], 64, 8, 16),
    "tc_counts_0_1_partial_c": (8, 2, 70, 64, 96, [70, 0, 1, 33, 5, 64, 0, 69],
                                64, 32, 32),
}


def _grouped_inputs(case, seed):
    G, E, C, K, N, counts = case[:6]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, C, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    for g, n in enumerate(counts):  # the routing pad past each count
        x[g, n:] = np.nan
    return x, w, np.asarray(counts, np.int32)


@pytest.mark.parametrize("name", list(GROUPED_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_plain_matches_pallas(name, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.grouped_gemm import vortex_grouped_gemm as pallas_gg

    case = GROUPED_CASES[name]
    bm, bn, bk = case[6:]
    x, w, counts = _grouped_inputs(case, seed=len(name))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = pallas_gg(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(counts),
        block_m=bm, block_n=bn, block_k=bk, interpret=True,
    )
    tdt = getattr(torch, dtype)
    out = vortex_grouped_gemm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
        torch.from_numpy(counts), block_m=bm, block_n=bn, block_k=bk,
    )
    assert out.dtype == tdt
    for g, n in enumerate(counts):  # rows past each count are exactly zero
        assert (out[g, n:] == 0).all()
    _close(out, np.asarray(ref.astype(jnp.float32)),
           TOL[np.float32 if dtype == "float32" else "bfloat16"], name)


def test_grouped_gemm_rejects_bad_shapes_and_blocks():
    x, w = torch.zeros(3, 4, 8), torch.zeros(2, 8, 5)
    with pytest.raises(ValueError):  # G = 3 is not a multiple of E = 2
        vortex_grouped_gemm(x, w, [4, 4, 4])
    with pytest.raises(ValueError):
        vortex_grouped_gemm(torch.zeros(4, 4, 8), w, [4] * 4, block_n=0)


# ---------------------------------------------------------------------------
# Conv: im2col + the GEMM
# ---------------------------------------------------------------------------

CONV_CASES = [
    # (b, h, w, cin, kh, kw, cout, stride)
    (2, 9, 7, 3, 3, 3, 5, 1),
    (1, 11, 10, 4, 3, 2, 6, 2),
    (3, 5, 5, 2, 1, 1, 4, 1),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[str(c) for c in CONV_CASES])
def test_im2col_matches_reference(case):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.conv import im2col as ref_im2col

    b, h, w, cin, kh, kw, _, stride = case
    x = np.random.default_rng(h).standard_normal((b, h, w, cin)).astype(
        np.float32)
    ref, ref_dims = ref_im2col(jnp.asarray(x), kh, kw, stride)
    cols, dims = im2col(torch.from_numpy(x), kh, kw, stride)
    assert dims == tuple(ref_dims)
    assert cols.is_contiguous()
    np.testing.assert_array_equal(cols.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", CONV_CASES, ids=[str(c) for c in CONV_CASES])
def test_conv2d_matches_reference(case):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ref import ref_conv2d as jax_conv2d

    b, h, w, cin, kh, kw, cout, stride = case
    rng = np.random.default_rng(w)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = rng.standard_normal((kh, kw, cin, cout)).astype(np.float32)
    for padding in ("VALID", "SAME"):
        ref = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(wt),
                                    stride=stride, padding=padding))
        _close(ref_conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                          stride=stride, padding=padding), ref,
               TOL[np.float32], f"ref_conv2d {padding}")
    out = vortex_conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                        stride=stride, block_m=16, block_n=8, block_k=8)
    _close(out, np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(wt),
                                      stride=stride, padding="VALID")),
           TOL[np.float32], "vortex_conv2d")


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
def test_conv1d_matches_reference(stride, padding):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ref import ref_conv1d as jax_conv1d

    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 13, 3)).astype(np.float32)
    wt = rng.standard_normal((4, 3, 5)).astype(np.float32)
    ref = jax_conv1d(jnp.asarray(x), jnp.asarray(wt), stride=stride,
                     padding=padding)
    _close(ref_conv1d(torch.from_numpy(x), torch.from_numpy(wt),
                      stride=stride, padding=padding), np.asarray(ref),
           TOL[np.float32], "ref_conv1d")


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        for M, N, K, m_true, bm, bn, bk in GEMM_CASES:
            rng = np.random.default_rng(M)
            a = torch.from_numpy(
                rng.standard_normal((M, K)).astype(np.float32)).to(dev, dtype)
            b = torch.from_numpy(
                rng.standard_normal((K, N)).astype(np.float32)).to(dev, dtype)
            a[m_true:] = float("nan")
            out = vortex_gemm(a, b, m_true, block_m=bm, block_n=bn, block_k=bk)
            ref = vortex_gemm_plain(a, b, m_true)
            _close(out.cpu(), ref.float().cpu().numpy(), tol, "gemm")
        for M, N, K, m_true, bm, bn, bk in TC_GEMM_CASES:
            rng = np.random.default_rng(M)
            a = torch.from_numpy(
                rng.standard_normal((M, K)).astype(np.float32)).to(dev, dtype)
            b = torch.from_numpy(
                rng.standard_normal((K, N)).astype(np.float32)).to(dev, dtype)
            a[m_true:] = float("nan")
            out = vortex_gemm(a, b, m_true, block_m=bm, block_n=bn, block_k=bk,
                              backend="tensor_core")
            assert (out[m_true:] == 0).all()
            ref = vortex_gemm_plain(a, b, m_true)
            _close(out.cpu(), ref.float().cpu().numpy(), tol, "gemm tensor_core")
        for name, case in ATTN_CASES.items():
            (b_, hq, hkv, sq, skv, d, bq, bk_, causal, window, softcap,
             kv_len, q_off) = case
            q, k, v = (torch.from_numpy(x).to(dev, dtype)
                       for x in _attn_inputs(case, seed=len(name)))
            kv_t = kv_len if isinstance(kv_len, int) else torch.tensor(kv_len)
            off_t = q_off if q_off is None or isinstance(q_off, int) \
                else torch.tensor(q_off)
            out = flash_attention(
                q, k, v, kv_t, off_t, block_q=bq, block_k=bk_, causal=causal,
                window=window, softcap=softcap,
            )
            ref = flash_attention_plain(
                q, k, v, kv_t, off_t, causal=causal, window=window,
                softcap=softcap,
            )
            _close(out.cpu(), ref.float().cpu().numpy(), 4 * tol, name)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_grouped_gemm_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        for name, case in GROUPED_CASES.items():
            bm, bn, bk = case[6:]
            x, w, counts = (torch.from_numpy(a).to(dev) for a in
                            _grouped_inputs(case, seed=len(name)))
            x, w = x.to(dtype), w.to(dtype)
            out = vortex_grouped_gemm(x, w, counts, block_m=bm, block_n=bn,
                                      block_k=bk)
            ref = vortex_grouped_gemm_plain(x, w, counts)
            for g, n in enumerate(counts.tolist()):
                assert (out[g, n:] == 0).all(), (name, g)
            _close(out.cpu(), ref.float().cpu().numpy(), tol, name)
        for name, case in TC_GROUPED_CASES.items():
            bm, bn, bk = case[6:]
            x, w, counts = (torch.from_numpy(a).to(dev) for a in
                            _grouped_inputs(case, seed=len(name)))
            x, w = x.to(dtype), w.to(dtype)
            out = vortex_grouped_gemm(x, w, counts, block_m=bm, block_n=bn,
                                      block_k=bk, backend="tensor_core")
            ref = vortex_grouped_gemm_plain(x, w, counts)
            for g, n in enumerate(counts.tolist()):
                assert (out[g, n:] == 0).all(), (name, g)
            _close(out.cpu(), ref.float().cpu().numpy(), tol, name)
    torch.cuda.synchronize()


# (b, hq, hkv, sq, skv, d, bq, bk, causal, window, softcap, kv_len, q_offset)
# at tiles the wgmma prefill kernel admits, and decode forms over many splits.
TC_ATTN_CASES = {
    "tc_causal": (2, 4, 2, 100, 100, 64, 64, 32, True, None, None, 90, None),
    "tc_two_warpgroups": (1, 4, 4, 130, 160, 64, 128, 128, False, None, None,
                          [150], None),
    "tc_rounds_d16": (1, 2, 2, 300, 300, 16, 1024, 16, True, 40, None, 290,
                      None),
    "tc_d128_softcap": (1, 2, 1, 70, 70, 128, 64, 64, True, None, 4.0, 70,
                        None),
    "decode_many_splits": (2, 8, 2, 1, 2048, 64, 1, 64, False, None, None,
                           [1500, 0], [1499, -1]),
    # The dense family's heads: h2o-danube3's 120 (ROADMAP C3) and gemma2's
    # 256 with its window and softcap; GQA groups 3 and 12 in decode.
    "tc_d120_c3": (1, 8, 2, 130, 130, 120, 128, 64, True, 64, None, 130,
                   None),
    "tc_d256_window_softcap": (1, 4, 2, 100, 100, 256, 64, 32, True, 40,
                               50.0, 100, None),
    "decode_group3": (2, 6, 2, 1, 300, 128, 1, 64, False, None, None,
                      [300, 17], [299, 16]),
    "decode_group12_d120": (2, 24, 2, 1, 300, 120, 1, 64, False, 100, None,
                            [300, 17], [299, 16]),
}


@pytest.mark.cuda
def test_cuda_attention_paths_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    from repro_torch import kernels

    dev = torch.device("cuda")
    for name, case in TC_ATTN_CASES.items():
        (b_, hq, hkv, sq, skv, d, bq, bk, causal, window, softcap, kv_len,
         q_off) = case
        q, k, v = (torch.from_numpy(x).to(dev, torch.bfloat16)
                   for x in _attn_inputs(case, seed=len(name)))
        kv_t = kv_len if isinstance(kv_len, int) else torch.tensor(kv_len)
        off_t = q_off if q_off is None or isinstance(q_off, int) \
            else torch.tensor(q_off)
        path = "decode.split_kv" if sq == 1 else "prefill.tensor_core"
        ref = flash_attention_plain(q, k, v, kv_t, off_t, causal=causal,
                                    window=window, softcap=softcap)
        for _ in range(2):  # the split-kv tickets are reset by each launch
            n0 = kernels.launch_counts()[f"flash_attention_{path}"]
            out = flash_attention(
                q, k, v, kv_t, off_t, block_q=bq, block_k=bk,
                backend="tensor_core", causal=causal, window=window,
                softcap=softcap,
            )
            assert kernels.launch_counts()[f"flash_attention_{path}"] == n0 + 1
            _close(out.cpu(), ref.float().cpu().numpy(), 2.0 ** -6, name)
            for i, n in enumerate(np.broadcast_to(np.asarray(kv_len), (b_,))):
                if n == 0:
                    assert (out[i] == 0).all(), name
            if sq == 1:
                split = flash_decode_split_plain(
                    q, k, v, kv_t, off_t, bk, causal=causal, window=window,
                    softcap=softcap)
                _close(out.cpu(), split.float().cpu().numpy(), 2.0 ** -6, name)
    torch.cuda.synchronize()
