"""The port's direct kernel wrappers (kernels/ops.py) on the CPU, where
each runs its kernel's plain version, against the JAX package's
``kernels.ops`` run with ``interpret=True``, at the reference's own
tolerances (tests/test_kernels.py: 1e-4 for f32 products, 2e-3 for
attention).  On the card each launches its hand-written kernel
(chip_smoke.py phase 10a); an operand on neither device raises."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.gemm import OperandError

RNG = np.random.default_rng(26)


def _np(shape):
    return RNG.normal(size=shape).astype(np.float32)


def _ref_ops():
    pytest.importorskip("jax")
    from repro.kernels import ops as ref

    return ref


@pytest.mark.parametrize("m,m_true", [(128, None), (128, 77), (200, 131)])
def test_matmul_matches_the_reference(m, m_true):
    ref = _ref_ops()
    import jax.numpy as jnp

    a, b = _np((m, 96)), _np((96, 160))
    want = ref.matmul(jnp.asarray(a), jnp.asarray(b), m_true,
                      block_m=64, block_n=64, block_k=32, interpret=True)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b), m_true,
                     block_m=64, block_n=64, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=16, softcap=30.0),
])
def test_attention_matches_the_reference(kw):
    ref = _ref_ops()
    import jax.numpy as jnp

    q, k, v = _np((2, 4, 40, 32)), _np((2, 2, 40, 32)), _np((2, 2, 40, 32))
    want = ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         block_q=16, block_k=16, interpret=True, **kw)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), block_q=16, block_k=16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_attention_kv_len_and_decode_form_match_the_reference():
    ref = _ref_ops()
    import jax.numpy as jnp

    q, k, v = _np((3, 4, 1, 32)), _np((3, 4, 48, 32)), _np((3, 4, 48, 32))
    kv_len = np.array([48, 20, 1], dtype=np.int32)
    want = ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(kv_len), block_q=8, block_k=16,
                         causal=False, interpret=True)
    for block_q in (8, 1):  # prefill form, then the split-kv decode form
        got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(kv_len),
                            block_q=block_q, block_k=16, causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_matches_the_reference(stride):
    ref = _ref_ops()
    import jax.numpy as jnp

    x, w = _np((2, 13, 11, 8)), _np((3, 3, 8, 16))
    want = ref.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                      block_m=64, block_n=64, block_k=64, interpret=True)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     stride=stride, block_m=64, block_n=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_defaults_are_the_reference_blocks():
    import inspect

    for fn, names in ((ops.matmul, ("block_m", "block_n", "block_k")),
                      (ops.attention, ("block_q", "block_k")),
                      (ops.conv2d, ("block_m", "block_n", "block_k"))):
        params = inspect.signature(fn).parameters
        assert all(params[n].default == 128 for n in names)
        assert params["backend"].default == "cuda_core"


def test_operands_off_both_devices_raise():
    """No plain-version fallback except for CPU operands: a meta tensor
    (neither the CPU nor the card) raises."""
    a = torch.empty(64, 64, device="meta")
    with pytest.raises(OperandError):
        ops.matmul(a, a)
    assert ops.on_cuda() == torch.cuda.is_available()
