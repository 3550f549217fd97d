"""Port parity: the batched banded Viterbi's plain version and wrapper.

`sepi_tpu_torch.align.viterbi_cuda.viterbi_batch_reference` against the
JAX Pallas kernel in interpret mode and its scan reference, on the same
numpy inputs: backpointers exactly equal over every state (including the
unreachable ones), delta within atol 1e-4 where the reference's delta is
live (> -1e29) and equal elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.align.viterbi_pallas import viterbi_batch as j_kernel
from sepi_tpu.align.viterbi_pallas import viterbi_batch_reference as j_ref
from sepi_tpu_torch.align import viterbi_cuda

torch.set_num_threads(2)

LIVE_ATOL = 1e-4


def _inputs(seed, b, t, s, skip, tlen, skip_p=0.3, all_skips=False):
    """As tests/test_align.py builds them: random emissions, stay 0.6,
    advance 0.4 from state 1, random (or all) skip arcs at 0.2."""
    rng = np.random.default_rng(seed)
    emit = rng.normal(size=(b, t, s)).astype(np.float32)
    trans = np.full((b, 3, s), -1e30, np.float32)
    trans[:, 0, :] = np.log(0.6)
    trans[:, 1, 1:] = np.log(0.4)
    if all_skips:
        trans[:, 2, skip:] = np.log(0.2)
    else:
        trans[:, 2, skip:] = np.where(rng.random((b, s - skip)) < skip_p, np.log(0.2), -1e30)
    return emit, np.asarray(tlen, np.int32), trans


def _tie_inputs(seed, b, t, s, skip, tlen):
    """Integer emissions and equal stay/advance/skip log-probs: exact
    float ties in c0/c1/c2 on almost every step."""
    rng = np.random.default_rng(seed)
    emit = rng.integers(-3, 1, size=(b, t, s)).astype(np.float32)
    trans = np.full((b, 3, s), -1e30, np.float32)
    trans[:, 0, :] = -1.0
    trans[:, 1, 1:] = -1.0
    trans[:, 2, skip:] = -1.0
    return emit, np.asarray(tlen, np.int32), trans


def _port(emit, tlen, trans, skip):
    bp, d = viterbi_cuda.viterbi_batch(torch.from_numpy(emit), torch.from_numpy(tlen),
                                       torch.from_numpy(trans), skip)
    return bp.numpy(), d.numpy()


def _assert_same(bp, d, bp_ref, d_ref):
    assert bp.dtype == np.int8 and bp.shape == bp_ref.shape and d.shape == d_ref.shape
    np.testing.assert_array_equal(bp, bp_ref)
    live = d_ref > -1e29
    np.testing.assert_allclose(d[live], d_ref[live], atol=LIVE_ATOL, rtol=0)
    np.testing.assert_array_equal(d[~live], d_ref[~live])


@pytest.mark.parametrize("case", ["align_147", "align_174"])
def test_plain_matches_jax_kernel_and_reference(case):
    if case == "align_147":
        args = _inputs(0, 3, 40, 128, 4, [40, 25, 33])
    else:  # S not a multiple of 128: the TPU wrapper's lane-padding case
        args = _inputs(1, 2, 30, 139, 4, [30, 17], all_skips=True)
    emit, tlen, trans = args
    bp, d = _port(emit, tlen, trans, 4)
    jargs = (jnp.asarray(emit), jnp.asarray(tlen), jnp.asarray(trans), 4)
    bp_k, d_k = j_kernel(*jargs, interpret=True)
    bp_r, d_r = j_ref(*jargs)
    _assert_same(bp, d, np.asarray(bp_r), np.asarray(d_r))
    _assert_same(bp, d, np.asarray(bp_k), np.asarray(d_k))


def test_tie_heavy_first_max_wins():
    """Pins first-max tie-breaking (stay, then advance, then skip)."""
    emit, tlen, trans = _tie_inputs(2, 3, 24, 128, 4, [24, 11, 1])
    bp, d = _port(emit, tlen, trans, 4)
    jargs = (jnp.asarray(emit), jnp.asarray(tlen), jnp.asarray(trans), 4)
    bp_r, d_r = j_ref(*jargs)
    bp_k, d_k = j_kernel(*jargs, interpret=True)
    _assert_same(bp, d, np.asarray(bp_r), np.asarray(d_r))
    _assert_same(bp, d, np.asarray(bp_k), np.asarray(d_k))
    # the case really is tie-heavy: every live score is an exact integer,
    # and all three arc kinds are taken
    assert (bp[0] == 1).sum() > 0 and (bp[0] == 2).sum() > 0
    live = d[d > -1e29]
    assert live.size and np.all(live == np.round(live))


def test_single_frame():
    emit, tlen, trans = _inputs(3, 2, 1, 16, 4, [1, 1])
    bp, d = _port(emit, tlen, trans, 4)
    assert bp.shape == (2, 0, 16)
    bp_r, d_r = j_ref(jnp.asarray(emit), jnp.asarray(tlen), jnp.asarray(trans), 4)
    _assert_same(bp, d, np.asarray(bp_r), np.asarray(d_r))
    assert d[0, 0] == emit[0, 0, 0] and np.all(d[:, 1:] == np.float32(-1e30))


def test_frozen_rows_are_zero_and_states_below_skip():
    """Past t_len the backpointers are 0 and delta is frozen; S below the
    skip width reads -1e30 for the missing neighbour (no wrap-around)."""
    emit, tlen, trans = _inputs(4, 2, 12, 6, 4, [5, 12], all_skips=True)
    bp, d = _port(emit, tlen, trans, 4)
    assert np.all(bp[0, 4:] == 0)
    bp_r, d_r = j_ref(jnp.asarray(emit), jnp.asarray(tlen), jnp.asarray(trans), 4)
    _assert_same(bp, d, np.asarray(bp_r), np.asarray(d_r))
    short, d_short = _port(emit[:1, :5].copy(), np.array([5], np.int32), trans[:1].copy(), 4)
    np.testing.assert_array_equal(bp[0, :4], short[0])
    np.testing.assert_array_equal(d[0], d_short[0])
    # S = 3 < skip: the skip candidate never exists
    bp3, _ = _port(emit[:, :, :3].copy(), tlen, trans[:, :, :3].copy(), 4)
    no_skip = trans[:, :, :3].copy()
    no_skip[:, 2] = -1e30
    bp3b, _ = _port(emit[:, :, :3].copy(), tlen, no_skip, 4)
    assert not np.any(bp3 == 2)
    np.testing.assert_array_equal(bp3, bp3b)


def test_wrapper_dispatches_cpu_to_plain_without_counting():
    emit, tlen, trans = _inputs(5, 2, 10, 32, 4, [10, 7])
    before = viterbi_cuda.viterbi_batch.launches
    bp, d = viterbi_cuda.viterbi_batch(torch.from_numpy(emit), torch.from_numpy(tlen),
                                       torch.from_numpy(trans), 4)
    bp2, d2 = viterbi_cuda.viterbi_batch_reference(
        torch.from_numpy(emit), torch.from_numpy(tlen), torch.from_numpy(trans), 4)
    assert viterbi_cuda.viterbi_batch.launches == before
    assert torch.equal(bp, bp2) and torch.equal(d, d2)


@pytest.mark.parametrize("skip", [1, 2, 8])
@pytest.mark.parametrize("s", [45, 139])
def test_plain_matches_jax_reference_across_skips(skip, s):
    """skip widths other than the aligner's 4 and S not a multiple of 32:
    the CUDA kernel lays S out as 32 lanes x K states and reaches s - skip
    across lanes, so the plain version it is held against must match the
    JAX reference for every skip."""
    emit, tlen, trans = _inputs(40 + skip, 3, 25, s, skip, [25, 2, 1], skip_p=0.5)
    bp, d = _port(emit, tlen, trans, skip)
    bp_r, d_r = j_ref(jnp.asarray(emit), jnp.asarray(tlen), jnp.asarray(trans), skip)
    _assert_same(bp, d, np.asarray(bp_r), np.asarray(d_r))
    if skip > 1:  # at skip 1 the skip arc duplicates the likelier advance
        assert (bp[0] == 2).sum() > 0
