"""Port parity: MFCC constants and FeatureExtractor (sepi_tpu_torch.ops).

Undithered features are compared with the JAX package's CPU default
(`FeatureExtractor(FrontendConfig(dither=0.0))`, the slices path) and
with the checked-in golden vectors at the tolerance of
tests/test_frontend_golden.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu import config as jcfg
from sepi_tpu.ops import features as jf
from sepi_tpu.ops import framing as jfr
from sepi_tpu_torch import config as tcfg
from sepi_tpu_torch.ops import features as tf
from sepi_tpu_torch.ops import framing as tfr

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "frontend_golden.npz")

KW = {
    "sre23": dict(dither=0.0),
    "snip23": dict(dither=0.0, snip_edges=True),
    "hires40": dict(dither=0.0, use_energy=False, num_mel_bins=40, num_ceps=40,
                    low_freq=40.0, high_freq=-200.0),
    "wide16k": dict(dither=0.0, sample_rate=16000, num_mel_bins=40, num_ceps=40,
                    low_freq=40.0, high_freq=-200.0),
}


def _cfgs(name):
    return jcfg.FrontendConfig(**KW[name]), tcfg.FrontendConfig(**KW[name])


@pytest.mark.parametrize("name", sorted(KW))
def test_constants_match(name):
    jc, tc = _cfgs(name)
    assert tc.frame_length == jc.frame_length and tc.frame_shift == jc.frame_shift
    assert tc.padded_window_size == jc.padded_window_size
    assert tc.high_freq_hz == jc.high_freq_hz and tc.nyquist == jc.nyquist
    np.testing.assert_array_equal(tf.mel_banks(tc), jf.mel_banks(jc))
    np.testing.assert_array_equal(tf.dct_matrix(tc.num_ceps, tc.num_mel_bins),
                                  jf.dct_matrix(jc.num_ceps, jc.num_mel_bins))
    np.testing.assert_array_equal(tf.lifter_coeffs(tc.num_ceps, tc.cepstral_lifter),
                                  jf.lifter_coeffs(jc.num_ceps, jc.cepstral_lifter))
    np.testing.assert_array_equal(tf.dft_basis(tc), jf.dft_basis(jc))
    np.testing.assert_array_equal(tf.fused_dft_basis(tc), jf.fused_dft_basis(jc))
    np.testing.assert_array_equal(tfr.window_function(tc), jfr.window_function(jc))


@pytest.mark.parametrize("snip", [False, True])
def test_num_frames_and_mirror_indices(snip):
    jc = jcfg.FrontendConfig(dither=0.0, snip_edges=snip)
    tc = tcfg.FrontendConfig(dither=0.0, snip_edges=snip)
    lengths = np.array([0, 150, 200, 207, 8000, 24123], np.int32)
    for n in lengths:
        assert tfr.num_frames(int(n), tc) == jfr.num_frames(int(n), jc)
    got = tfr.num_frames(torch.from_numpy(lengths), tc).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfr.num_frames(jnp.asarray(lengths), jc)))
    # exact mirror gather for the first and last frames of a short utterance
    length = 207
    frames = np.arange(int(jfr.num_frames(length, jc)))
    ref = np.asarray(jfr._frame_indices(len(frames), length, jc))
    got = tfr.frame_indices(torch.from_numpy(frames)[None], torch.tensor([length]), tc)[0]
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("snip", [False, True])
def test_undithered_mfcc_matches_reference(snip):
    jc = jcfg.FrontendConfig(dither=0.0, snip_edges=snip)
    tc = tcfg.FrontendConfig(dither=0.0, snip_edges=snip)
    rng = np.random.default_rng(3 + snip)
    n = 3 * 8000 + 123
    samples = (rng.normal(size=(3, n)) * 3000).astype(np.float32)
    lengths = np.array([n, int(0.61 * n), jc.frame_length + 7], np.int32)
    ref, mref = jf.FeatureExtractor(jc).mfcc(samples, lengths)
    got, mask = tf.FeatureExtractor(tc, device="cpu").mfcc(samples, lengths)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mref))
    err = np.abs(got.numpy() - np.asarray(ref)).max()
    assert err <= 1e-3, err


@pytest.mark.parametrize("name", ["sre23", "hires40", "snip23"])
def test_mfcc_matches_golden_vectors(name):
    golden = np.load(FIXTURE)
    kw = {"sre23": KW["sre23"], "hires40": KW["hires40"], "snip23": KW["snip23"]}[name]
    feats, mask = tf.FeatureExtractor(tcfg.FrontendConfig(**kw), device="cpu").mfcc(
        golden["audio"], None)
    got = feats.numpy()[mask.numpy()]
    ref = golden[f"mfcc_{name}"]
    assert got.shape == ref.shape
    span = np.maximum(ref.max(axis=0) - ref.min(axis=0), 1.0)
    tol = np.maximum(1e-3, 1e-4 * span)
    err = np.abs(got - ref).max(axis=0)
    assert np.all(err <= tol), (err, tol)


def test_single_utterance_and_seed_gating():
    """A 1-D input squeezes; without seeds a dithered config is undithered,
    as in the reference."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=4000) * 1000).astype(np.float32)
    fe = tf.FeatureExtractor(tcfg.FrontendConfig(), device="cpu")
    f1, m1 = fe.mfcc(x)
    f0, _ = tf.FeatureExtractor(tcfg.FrontendConfig(dither=0.0), device="cpu").mfcc(x)
    assert f1.shape == (50, 23) and m1.shape == (50,)
    np.testing.assert_array_equal(f1.numpy(), f0.numpy())
    fd, _ = fe.mfcc(x, utt_seeds=[5])
    assert not np.array_equal(fd.numpy(), f0.numpy())


def test_unsupported_config_raises():
    """A config outside the MFCC kernel's gate raises in `mfcc`; the
    filterbank, which no kernel computes, takes it."""
    fe = tf.FeatureExtractor(tcfg.FrontendConfig(raw_energy=False), device="cpu")
    x = np.ones(4000, np.float32)
    with pytest.raises(ValueError, match="gate"):
        fe.mfcc(x)
    assert fe.fbank(x)[0].shape == (50, 23)
    with pytest.raises(ValueError, match="gate"):
        tf.FeatureExtractor(tcfg.FrontendConfig(frame_shift_ms=9.125), device="cpu").mfcc(x)
