"""The port's deprecation shims (vortex/compat.py, the lazy re-exports
from repro_torch.core and repro_torch.core.engine, and the three layer
shims) mirroring tests/test_vortex_api.py:254-347: each shim warns with
``VortexDeprecationWarning`` and is bit-identical and key-identical
(dispatch, kernel and executable-cache keys) to the new surface.

The reference's tier-1 settings turn only the JAX package's warning
category into an error (pyproject.toml), and the pytest settings stay as
they are, so the last test enforces the port's category with a local
``warnings.simplefilter("error", ...)``."""
import warnings

import numpy as np
import pytest
import torch

from repro_torch import vortex
from repro_torch.core.workloads import GemmWorkload
from repro_torch.vortex._deprecation import VortexDeprecationWarning

RNG = np.random.default_rng(254)


def _arr(shape):
    return torch.from_numpy(RNG.normal(size=shape).astype(np.float32))


def _engine():
    return vortex.Engine(hardware="tpu_v5e", device="cpu",
                         empirical_levels=())


def _shim():
    from repro_torch.core import VortexEngine

    return VortexEngine("tpu_v5e", device="cpu", empirical_levels=())


def test_shims_resolve_from_their_historical_homes():
    from repro_torch.core import VortexEngine, VortexGemm
    from repro_torch.core import engine
    from repro_torch.vortex import compat

    assert VortexEngine is engine.VortexEngine is compat.VortexEngine
    assert VortexGemm is engine.VortexGemm is compat.VortexGemm
    assert issubclass(VortexDeprecationWarning, DeprecationWarning)
    with pytest.raises(AttributeError):
        engine.NoSuchShim  # noqa: B018


def test_vortex_engine_shim_parity_gemm():
    a, b = _arr((13, 48)), _arr((48, 32))
    old, new = _shim(), _engine()
    with pytest.warns(VortexDeprecationWarning, match="VortexEngine.gemm"):
        y_old = old.gemm(a, b)
    y_new = new.dispatch("gemm", a, b)
    assert torch.equal(y_old, y_new)
    assert set(old._dispatch) == set(new._dispatch) == {("gemm", 48, 32)}
    assert set(old._kernels) == set(new._kernels)
    k_old = next(iter(old._kernels.values()))
    k_new = next(iter(new._kernels.values()))
    assert set(k_old._exec_cache) == set(k_new._exec_cache)


def test_vortex_engine_shim_parity_attention_and_conv():
    old, new = _shim(), _engine()
    q, k, v = _arr((1, 4, 19, 32)), _arr((1, 2, 19, 32)), _arr((1, 2, 19, 32))
    with pytest.warns(VortexDeprecationWarning):
        y_old = old.attention(q, k, v, window=8)
    y_new = new.dispatch("attention", q, k, v, window=8)
    assert torch.equal(y_old, y_new)

    x, w = _arr((2, 9, 9, 4)), _arr((3, 3, 4, 8))
    with pytest.warns(VortexDeprecationWarning):
        c_old = old.conv2d(x, w)
    c_new = new.dispatch("conv2d", x, w)
    assert torch.equal(c_old, c_new)
    assert set(old._dispatch) == set(new._dispatch)
    assert set(old._kernels) == set(new._kernels)
    with pytest.warns(VortexDeprecationWarning, match="gemm_for"):
        kern = old.gemm_for(32, 48)
    assert kern is old.kernel_for(GemmWorkload(M=None, N=32, K=48))


def test_vortex_gemm_shim_warns_and_matches_kernel():
    from repro_torch.core import VortexGemm, VortexKernel
    from repro_torch.core.hardware import TPU_V5E

    wl = GemmWorkload(M=None, N=24, K=32)
    with pytest.warns(VortexDeprecationWarning, match="VortexGemm"):
        old = VortexGemm(TPU_V5E, wl, impl="torch", empirical_levels=())
    new = VortexKernel(TPU_V5E, wl, impl="torch", empirical_levels=())
    a, b = _arr((9, 32)), _arr((32, 24))
    assert torch.equal(old(a, b), new(a, b))
    assert set(old._exec_cache) == set(new._exec_cache)
    assert old.select(9).bucket == new.select(9).bucket


def test_set_attention_engine_shim_delegates_to_contextvar():
    """The deprecated imperative surface is a view over the same context
    variable vortex.use writes."""
    from repro_torch.models import layers

    eng = _engine()
    with pytest.warns(VortexDeprecationWarning, match="set_attention_engine"):
        prev = layers.set_attention_engine(eng)
    assert prev is None
    assert vortex.installed_engine() is eng
    with pytest.warns(VortexDeprecationWarning, match="get_attention_engine"):
        assert layers.get_attention_engine() is eng
    with pytest.warns(VortexDeprecationWarning, match="set_attention_engine"):
        assert layers.set_attention_engine(None) is eng
    assert vortex.installed_engine() is None
    with vortex.use(eng):
        with pytest.warns(VortexDeprecationWarning):
            assert layers.get_attention_engine() is eng


def test_attention_engine_contextmanager_shim():
    from repro_torch.models import layers

    eng = _engine()
    with pytest.warns(VortexDeprecationWarning, match="attention_engine"):
        with layers.attention_engine(eng):
            assert vortex.installed_engine() is eng
    assert vortex.installed_engine() is None


def test_uncaught_shim_call_raises_under_the_error_filter():
    """With the port's category made an error (as tier-1 makes the
    reference's), an un-caught shim call raises: internal callers cannot
    slip back onto the old surface unnoticed."""
    eng = _shim()
    with warnings.catch_warnings():
        warnings.simplefilter("error", VortexDeprecationWarning)
        with pytest.raises(VortexDeprecationWarning):
            eng.gemm(_arr((4, 8)), _arr((8, 4)))
