"""Port parity: counter-hash dither (sepi_tpu_torch.ops.dither).

Hash bits must be exact against the JAX package; the Box-Muller normals
may differ by a few float32 ulps (different log/cos/sin), so 1e-5 abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu.ops import dither as jd
from sepi_tpu_torch.ops import dither as td

torch.set_num_threads(2)


def _u32(rng, shape):
    v = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    v.flat[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]  # edge values, incl. >= 2^31
    return v


def test_fmix32_bits_exact():
    x = _u32(np.random.default_rng(0), (4096,))
    ref = np.asarray(jd._fmix32(jnp.asarray(x)))
    got = td.fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    assert got.min() >= 0 and got.max() < 2**32


def test_u24_bits_exact():
    rng = np.random.default_rng(1)
    seed, ctr = _u32(rng, (2048,)), _u32(rng, (2048,))
    ref = np.asarray(jd._u24(jnp.asarray(seed), jnp.asarray(ctr)))
    got = td.u24(torch.from_numpy(seed.astype(np.int64)),
                 torch.from_numpy(ctr.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("span", [10400, 600, 1 << 27])
def test_hash_normal_pair_matches(span):
    rng = np.random.default_rng(span)
    seed = _u32(rng, (8, 1))
    ctr = np.arange(512, dtype=np.uint32)[None, :]
    r1, r2 = jd.hash_normal_pair(jnp.asarray(seed), jnp.asarray(ctr), span)
    g1, g2 = td.hash_normal_pair(torch.from_numpy(seed.astype(np.int64)),
                                 torch.from_numpy(ctr.astype(np.int64)), span)
    assert g1.dtype == torch.float32
    np.testing.assert_allclose(g1.numpy(), np.asarray(r1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(r2), rtol=0, atol=1e-5)
    h = td.hash_normal(torch.from_numpy(seed.astype(np.int64)),
                       torch.from_numpy(ctr.astype(np.int64)), span)
    np.testing.assert_array_equal(h.numpy(), g1.numpy())


def test_counter_wraps_at_32_bits():
    """counter + span past 2^32 wraps, as uint32 arithmetic does."""
    seed = np.array([[12345]], np.uint32)
    ctr = np.array([[2**32 - 3, 2**32 - 1]], np.uint32)
    r1, _ = jd.hash_normal_pair(jnp.asarray(seed), jnp.asarray(ctr), 10)
    g1, _ = td.hash_normal_pair(torch.from_numpy(seed.astype(np.int64)),
                                torch.from_numpy(ctr.astype(np.int64)), 10)
    np.testing.assert_allclose(g1.numpy(), np.asarray(r1), atol=1e-5)


@pytest.mark.parametrize("base_seed", [0, 7, 2**30 + 5])
def test_utt_seeds_match(base_seed):
    ids = [f"spk{i:03d}-utt{j:03d}" for i in range(5) for j in range(4)]
    np.testing.assert_array_equal(td.utt_seeds(ids, base_seed), jd.utt_seeds(ids, base_seed))
    assert td.utt_seed("a", base_seed) == jd.utt_seed("a", base_seed)
    # an int salt is the reference's key-drawn salt xor'ed into the base
    np.testing.assert_array_equal(td.utt_seeds(ids, base_seed, salt=99),
                                  jd.utt_seeds(ids, base_seed ^ 99))
