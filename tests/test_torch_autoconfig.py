"""The port's framework auto-configuration (core/autoconfig.py) against
the JAX package's: the four tests of tests/test_autoconfig.py, exact
equality over a grid of inputs at the reference's default spec, and the
reference's behaviour at ``H100_SXM`` pinned."""
import itertools

import pytest

from repro_torch.core.autoconfig import select_attn_chunk, select_microbatches
from repro_torch.core.hardware import H100_SXM, TPU_V5E


def test_attn_chunk_is_lattice_aligned_and_bounded():
    c = select_attn_chunk(seq=32768, head_dim=128, q_rows=4096)
    assert c % 128 == 0
    assert 128 <= c <= 32768
    # VMEM bound: K,V chunk + f32 scores must fit the budget.
    ws = 2 * c * 128 * 2 + 4096 * c * 4
    assert ws <= 0.25 * 128 * 1024 * 1024 * 0.5 + 0.25 * 64 * 1024 * 1024


def test_attn_chunk_shrinks_with_q_rows():
    big_q = select_attn_chunk(seq=32768, head_dim=128, q_rows=8192)
    small_q = select_attn_chunk(seq=32768, head_dim=128, q_rows=256)
    assert big_q <= small_q


def test_microbatches_grow_with_vocab():
    kw = dict(global_batch=256, seq=4096, d_model=4096,
              n_data_shards=16, n_model_shards=16)
    small = select_microbatches(vocab=32000, **kw)
    big = select_microbatches(vocab=256000, **kw)
    assert big >= small
    assert small >= 1 and (small & (small - 1)) == 0  # power of two


def test_microbatches_account_for_moe():
    kw = dict(global_batch=256, seq=4096, d_model=5120, vocab=102400,
              n_data_shards=16, n_model_shards=16)
    dense = select_microbatches(**kw)
    moe = select_microbatches(moe_experts=160, moe_topk=6, **kw)
    assert moe >= dense


SEQS = (1, 100, 128, 1000, 4096, 32768, 524288)
HEAD_DIMS = (32, 64, 120, 128, 256)
Q_ROWS = (1, 16, 256, 4096, 8192)


@pytest.mark.parametrize("seq", SEQS)
def test_attn_chunk_equals_the_reference(seq):
    pytest.importorskip("jax")
    from repro.core.autoconfig import select_attn_chunk as ref

    for hd, q in itertools.product(HEAD_DIMS, Q_ROWS):
        for frac in (0.25, 0.5):
            assert select_attn_chunk(seq, hd, q, vmem_frac=frac) == ref(
                seq, hd, q, vmem_frac=frac), (seq, hd, q, frac)


def test_microbatches_equal_the_reference():
    pytest.importorskip("jax")
    from repro.core.autoconfig import select_microbatches as ref

    grid = itertools.product(
        (1, 8, 256), (1024, 4096, 32768), (768, 4096, 5120),
        (32000, 102400, 256000), (1, 16, 32), (1, 16),
        ((0, 0), (160, 6), (32, 8)), (0.25, 0.5))
    for gb, seq, d, vocab, nd, nm, (e, k), frac in grid:
        kw = dict(global_batch=gb, seq=seq, d_model=d, vocab=vocab,
                  n_data_shards=nd, n_model_shards=nm, moe_experts=e,
                  moe_topk=k, hbm_activation_frac=frac)
        assert select_microbatches(**kw) == ref(**kw), kw


def test_h100_attn_chunk_falls_through_at_head_dim_128():
    """At H100_SXM level 1 is the 232,448-byte shared-memory cap: a
    quarter of it (58,112 bytes) holds no chunk of 128 or more at
    head_dim 128 (65,536 bytes of K and V alone), whatever q_rows is, so
    the reference's rule falls through to min(1024, seq)."""
    assert H100_SXM.level(1).capacity_bytes == 232448
    assert 2 * 128 * 128 * 2 > 0.25 * 232448
    for q in Q_ROWS:
        for seq in (128, 512, 4096, 32768):
            assert select_attn_chunk(seq, 128, q, hw=H100_SXM) == min(
                1024, seq)


def test_microbatches_ignore_hw():
    """The budget is a fixed 16 GiB share, as in the reference: the spec
    does not move the answer."""
    kw = dict(global_batch=256, seq=4096, d_model=4096, vocab=256000,
              n_data_shards=16, n_model_shards=16)
    assert select_microbatches(hw=H100_SXM, **kw) == select_microbatches(
        hw=TPU_V5E, **kw)
