"""The paper's baselines in the port (core/baselines.py), held against the
JAX package's (src/repro/core/baselines.py): ``VendorBaseline`` is the
exact-shape library matmul, ``SampleDrivenCompiler`` searches the same
M-tile space per sample and routes and pads every runtime M as the
reference does.  Mirrors tests/test_system.py's baseline cases.
"""
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.core import HOST_CPU as REF_HOST_CPU  # noqa: E402
from repro.core import GemmWorkload as RefGemm  # noqa: E402
from repro.core import VortexKernel as RefKernel  # noqa: E402
from repro.core.baselines import SampleDrivenCompiler as RefSampled  # noqa: E402
from repro.core.baselines import VendorBaseline as RefVendor  # noqa: E402
from repro.core.candidates import (  # noqa: E402
    generate_lattice as ref_generate_lattice,
)

from repro_torch.core import HOST_CPU, GemmWorkload, VortexKernel  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    SampleDrivenCompiler,
    VendorBaseline,
)
from repro_torch.core.candidates import generate_lattice  # noqa: E402


def test_vendor_baseline_correctness():
    wl = GemmWorkload(M=None, N=64, K=32)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(17, 32)).astype(np.float32)
    b = rng.normal(size=(32, 64)).astype(np.float32)
    out = VendorBaseline(wl)(torch.from_numpy(a), torch.from_numpy(b))
    ref = RefVendor(RefGemm(M=None, N=64, K=32))(jnp.asarray(a),
                                                 jnp.asarray(b))
    assert out.shape == (17, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4)


SAMPLES = [32, 64, 96, 128]


@pytest.fixture(scope="module")
def compilers():
    port = SampleDrivenCompiler(
        HOST_CPU, GemmWorkload(M=None, N=128, K=128), samples=SAMPLES,
        search_budget=4, repeats=2, device="cpu",
    )
    ref = RefSampled(
        REF_HOST_CPU, RefGemm(M=None, N=128, K=128), samples=SAMPLES,
        search_budget=4, repeats=2,
    )
    return port, ref


def test_padded_m_matches_the_reference_in_range(compilers):
    port, ref = compilers
    for m in range(1, max(SAMPLES) + 1):
        assert port.padded_m(m) == ref.padded_m(m), m


def test_tile_search_spans_the_reference_tile_space(compilers):
    """Both tuners search the same M tiles (the host lattice's, capped at
    the budget), and past the largest sample pad to a multiple of the
    tile the search kept."""
    port, ref = compilers
    wl = GemmWorkload(M=None, N=128, K=128)
    space = sorted({t[0] for t in generate_lattice(
        HOST_CPU, wl, HOST_CPU.default_backend).l1})[:4]
    ref_space = sorted({t[0] for t in ref_generate_lattice(
        REF_HOST_CPU, RefGemm(M=None, N=128, K=128),
        REF_HOST_CPU.default_backend).l1})[:4]
    assert space == ref_space
    for comp in (port, ref):
        assert [k.sample_m for k in comp._kernels] == SAMPLES
        assert all(k.tile_m in space and k.best_us > 0
                   for k in comp._kernels)
        for m in (129, 200, 377):
            assert comp.padded_m(m) % comp._kernels[-1].tile_m == 0
            assert comp.padded_m(m) >= m


def test_sampled_call_is_the_padded_matmul(compilers):
    port, _ = compilers
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32))
    for m in (5, 64, 100, 200):
        a = torch.from_numpy(rng.normal(size=(m, 128)).astype(np.float32))
        out = port(a, b)
        assert out.shape == (m, 128)
        np.testing.assert_allclose(out.numpy(), (a @ b).numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_offline_stage_and_tuning_are_both_timed(compilers):
    """Paper §7.4's two offline costs, measured the same way on both sides:
    Vortex's sample-free build (no samples anywhere) and the per-sample
    empirical search.  In the reference the search also pays one XLA
    compile per padded shape, which makes it the dearer of the two; the
    port's torch.matmul compiles nothing, so only the reference's ordering
    is asserted here (the port's numbers are the benches' to report)."""
    port, ref = compilers
    t0 = time.perf_counter()
    vortex = VortexKernel(HOST_CPU, GemmWorkload(M=None, N=128, K=128),
                          empirical_levels=(), impl="torch")
    vortex_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_vortex = RefKernel(REF_HOST_CPU, RefGemm(M=None, N=128, K=128),
                           empirical_levels=())
    ref_vortex_s = time.perf_counter() - t0
    assert ref.tuning_seconds > ref_vortex_s
    assert port.tuning_seconds > 0 and vortex_s > 0
    assert vortex.offline_stats.num_candidates == \
        ref_vortex.offline_stats.num_candidates > 0
