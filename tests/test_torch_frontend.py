"""Port parity: MFCC constants and FeatureExtractor (sepi_tpu_torch.ops).

Undithered features are compared with the JAX package's CPU default
(`FeatureExtractor(FrontendConfig(dither=0.0))`, the slices path) and
with the checked-in golden vectors at the tolerance of
tests/test_frontend_golden.py.
"""

import dataclasses
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


# configs outside the fused MFCC's gate, and one inside it, for the stepwise
# route; each runs undithered and with seeded dither
STEPWISE = {
    "no_raw_energy": dict(raw_energy=False),
    "shift_9125": dict(frame_shift_ms=9.125),
    "shift_over_length": dict(frame_length_ms=8.0, frame_shift_ms=10.0),
    "no_energy": dict(use_energy=False),
}
STEP_TOL = 1e-3


def _stepwise_pair(kw, dither, seed, mode="slices"):
    """(port features, reference features) of the reference's stepwise
    route, `FeatureExtractor(cfg, spectral_mode="slices")`, on the same
    inputs; the dithered reference takes the same per-utterance seeds."""
    jc = jcfg.FrontendConfig(dither=dither, **kw)
    tc = tcfg.FrontendConfig(dither=dither, **kw)
    rng = np.random.default_rng(seed)
    n = 2 * 8000 + 321
    samples = (rng.normal(size=(3, n)) * 2000).astype(np.float32)
    lengths = np.array([n, int(0.55 * n), 400], np.int32)
    seeds = np.array([11, -5, 2**30 + 7], np.int32) if dither else None
    ref, mref = jf.FeatureExtractor(jc, spectral_mode="slices").mfcc(samples, lengths,
                                                                     utt_seeds=seeds)
    got, mask = tf.FeatureExtractor(tc, device="cpu", spectral_mode=mode).mfcc(
        samples, lengths, utt_seeds=seeds)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mref))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("dither", [0.0, 1.0], ids=["plain", "dithered"])
@pytest.mark.parametrize("case", sorted(STEPWISE))
def test_stepwise_mfcc_matches_reference(case, dither):
    got, ref = _stepwise_pair(STEPWISE[case], dither, len(case))
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= STEP_TOL, err


def test_unsupported_config_raises():
    """Configs outside the MFCC kernel's gate take the reference's stepwise
    route under the default mode ("auto"): both held against the
    reference's `spectral_mode="slices"` features, undithered and dithered.
    (Before the stepwise route was ported, `mfcc` raised for them.)"""
    x = np.ones(4000, np.float32)
    for kw, frames in ((dict(raw_energy=False), 50), (dict(frame_shift_ms=9.125), 55)):
        fe = tf.FeatureExtractor(tcfg.FrontendConfig(**kw), device="cpu")
        assert not fe.fused
        assert fe.mfcc(x)[0].shape == (frames, 23)
        assert fe.fbank(x)[0].shape == (frames, 23)
        for dither in (0.0, 1.0):
            got, ref = _stepwise_pair(kw, dither, 7, mode="auto")
            assert np.abs(got - ref).max() <= STEP_TOL


@pytest.mark.parametrize("mode", ["auto", "pallas", "slices", "conv"])
def test_spectral_modes(mode):
    """In the gate, "auto" and "pallas" run the fused MFCC (its plain
    version on the CPU) and "slices"/"conv" the stepwise route; all four
    agree with the reference's stepwise features on an undithered config."""
    tc = tcfg.FrontendConfig(dither=0.0)
    fe = tf.FeatureExtractor(tc, device="cpu", spectral_mode=mode)
    assert fe.fused == (mode in ("auto", "pallas"))
    got, ref = _stepwise_pair({}, 0.0, 5, mode=mode)
    assert np.abs(got - ref).max() <= STEP_TOL
    # outside the gate every mode takes the stepwise route
    assert not tf.FeatureExtractor(tcfg.FrontendConfig(raw_energy=False), device="cpu",
                                   spectral_mode=mode).fused


def test_unknown_spectral_mode_raises():
    with pytest.raises(ValueError, match="spectral_mode"):
        tf.FeatureExtractor(tcfg.FrontendConfig(), device="cpu", spectral_mode="fft")


@pytest.mark.parametrize("preset", ["MFCC_SRE_XVECTOR", "MFCC_SNIP_EDGES", "MFCC_ASR"])
def test_new_presets_match_reference_kernel(preset):
    """The presets equal the reference's, pass the fused MFCC's gate, and
    their dithered features through the kernel's plain version hold
    against the reference kernel in interpret mode."""
    from sepi_tpu.ops import mfcc_pallas as jm
    from sepi_tpu_torch.ops import mfcc_cuda as tm

    jc, tc = getattr(jcfg, preset), getattr(tcfg, preset)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tm.supported(tc) and jm.supported(jc)
    rng = np.random.default_rng(9)
    n = 8000 + 517
    samples = (rng.normal(size=(2, n)) * 2000).astype(np.float32)
    lengths = np.array([n, 3001], np.int32)
    seeds = np.array([3, 2**29 + 1], np.int32)
    tmax = int(jfr.num_frames(n, jc))
    ref, mref = jm.mfcc_fused(jnp.asarray(samples), jnp.asarray(lengths), jc, tmax,
                              interpret=True, seeds=jnp.asarray(seeds))
    got, mask = tf.FeatureExtractor(tc, device="cpu").mfcc(samples, lengths, utt_seeds=seeds)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mref))
    assert got.shape == (2, tmax, tc.num_ceps)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 2e-3
