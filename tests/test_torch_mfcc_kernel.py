"""Port parity: the fused MFCC's plain version (sepi_tpu_torch.ops.mfcc_cuda).

`mfcc_fused_reference` is what the CUDA kernel is held against on the
card; here it is held against the JAX kernel run in interpret mode, which
is the reference's main path for dithered configs (its CPU default runs a
different, per-frame dither).  Inputs span more than one 256-frame noise
tile, so the tile boundary and its halo frames are covered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu import config as jcfg
from sepi_tpu.ops import mfcc_pallas as jm
from sepi_tpu.ops.framing import num_frames
from sepi_tpu_torch import config as tcfg
from sepi_tpu_torch.ops import mfcc_cuda as tm

torch.set_num_threads(2)


def _inputs(seed, n=3 * 8000 + 123):
    rng = np.random.default_rng(seed)
    samples = (rng.normal(size=(3, n)) * 3000).astype(np.float32)
    lengths = np.array([n, int(0.61 * n), 207], np.int32)
    seeds = np.array([11, -5, 2**30 + 7], np.int32)
    return samples, lengths, seeds


@pytest.mark.parametrize("dither", [0.0, 1.0])
@pytest.mark.parametrize("snip", [False, True])
def test_plain_matches_interpret_kernel(dither, snip):
    jc = jcfg.FrontendConfig(dither=dither, snip_edges=snip)
    tc = tcfg.FrontendConfig(dither=dither, snip_edges=snip)
    samples, lengths, seeds = _inputs(int(dither) + 2 * snip)
    tmax = int(num_frames(samples.shape[1], jc))
    assert tmax > tm.NOISE_TILE + 2  # crosses a noise-tile boundary
    use = seeds if dither else None
    ref, mref = jm.mfcc_fused(jnp.asarray(samples), jnp.asarray(lengths), jc, tmax,
                              interpret=True, seeds=use)
    got, mask = tm.mfcc_fused_reference(
        torch.from_numpy(samples), torch.from_numpy(lengths), tc, tmax,
        None if use is None else torch.from_numpy(use))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mref))
    err = np.abs(got.numpy() - np.asarray(ref)).max()
    assert err < 2e-3, err
    # the halo frames at the tile edge, on their own
    edge = slice(tm.NOISE_TILE - 3, tm.NOISE_TILE + 2)
    assert np.abs(got.numpy()[0, edge] - np.asarray(ref)[0, edge]).max() < 2e-3


def test_tail_only_utterance_dithered():
    """A 207-sample utterance alone: every frame is a recomputed tail frame."""
    jc, tc = jcfg.FrontendConfig(), tcfg.FrontendConfig()
    x = (np.random.default_rng(8).normal(size=(1, 207)) * 500).astype(np.float32)
    l, s = np.array([207], np.int32), np.array([42], np.int32)
    tmax = int(num_frames(207, jc))
    ref, mref = jm.mfcc_fused(jnp.asarray(x), jnp.asarray(l), jc, tmax,
                              interpret=True, seeds=s)
    got, mask = tm.mfcc_fused_reference(torch.from_numpy(x), torch.from_numpy(l), tc,
                                        tmax, torch.from_numpy(s))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mref))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 2e-3


def test_noise_is_tied_to_reference_tiles():
    """Frame 255's last samples and frame 256's first samples are the
    same signal samples, but the reference draws them from different
    tiles' maps (255 reads tile 0's halo rows), so their noise differs;
    inside a tile, overlapping frames share their samples' noise."""
    tc = tcfg.FrontendConfig()
    flen, shift = tc.frame_length, tc.frame_shift
    z = tm.noise_frames(torch.tensor([123], dtype=torch.int32), 300, tc)[0].numpy()
    ov = flen - shift  # overlap of consecutive frames
    assert not np.allclose(z[255, shift:], z[256, :ov])
    np.testing.assert_array_equal(z[100, shift:], z[101, :ov])
    np.testing.assert_array_equal(z[256, shift:], z[257, :ov])
    # standard normal, roughly
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05


def test_supported_and_constants_match():
    for kw in [{}, {"snip_edges": True}, {"frame_shift_ms": 9.125},
               {"raw_energy": False}, {"sample_rate": 16000}, {"frame_length_ms": 5.0}]:
        assert tm.supported(tcfg.FrontendConfig(**kw)) == jm.supported(jcfg.FrontendConfig(**kw))
    for got, ref in zip(tm.reduced_spectral_consts(tcfg.FrontendConfig()),
                        jm.reduced_spectral_consts(jcfg.FrontendConfig())):
        np.testing.assert_array_equal(got, np.asarray(ref).reshape(got.shape))


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    tc = tcfg.FrontendConfig()
    samples, lengths, seeds = _inputs(5, n=4000)
    args = (torch.from_numpy(samples), torch.from_numpy(lengths), tc, 50,
            torch.from_numpy(seeds))
    before = tm.mfcc_fused.launches
    got, mask = tm.mfcc_fused(*args)
    ref, mref = tm.mfcc_fused_reference(*args)
    assert tm.mfcc_fused.launches == before
    assert torch.equal(got, ref) and torch.equal(mask, mref)
    with pytest.raises(ValueError):
        tm.mfcc_fused(args[0], args[1], tc.replace(raw_energy=False), 50)


def test_mel_band_ranges_cover_every_nonzero_weight():
    """The kernel sums each mel band over [mel_lo, mel_hi) only."""
    for kw in [{}, {"num_mel_bins": 40, "low_freq": 40.0, "high_freq": -200.0}]:
        tc = tcfg.FrontendConfig(**kw)
        c = tm._consts(tc, torch.device("cpu"))
        mel = c.mel.numpy()
        for m in range(mel.shape[1]):
            nz = np.nonzero(mel[:, m])[0]
            assert nz.min() >= c.mel_lo[m] and nz.max() < c.mel_hi[m]
