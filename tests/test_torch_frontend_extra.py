"""Port parity of the frontend's remaining public functions and the Kaldi
alignment readers, against `sepi_tpu`.

- `FeatureExtractor.fbank` and the functional `fbank`: against the
  reference's `FeatureExtractor.fbank` (its XLA path, no kernel), log and
  linear, undithered and dithered through per-utterance seeds; log values
  within 1e-3, linear within 1e-3 relative (the MFCC parity limit of
  tests/test_torch_frontend.py);
- `framing.raw_frames` equal to the reference's on every valid frame,
  `framing.frame_signal` within 1e-5 relative (dithered too);
- `select.select_voiced_counts` equal to the reference's;
- `utils.kaldi_io.{iter_int_vector_ark, read_ali_ark, read_ali_dir,
  read_feats_scp}` equal to the reference's on archives written here,
  gzipped and plain; a corrupt count raises in both.
"""

import gzip
import io
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepi_tpu import config as jcfg
from sepi_tpu.ops import features as jf
from sepi_tpu.ops import framing as jfr
from sepi_tpu.ops.dither import utt_seeds as jutt_seeds
from sepi_tpu.ops.select import select_voiced_counts as jselect_counts
from sepi_tpu.utils import kaldi_io as jkio
from sepi_tpu_torch import config as tcfg
from sepi_tpu_torch.ops import features as tf
from sepi_tpu_torch.ops import framing as tfr
from sepi_tpu_torch.ops.dither import utt_seeds
from sepi_tpu_torch.ops.select import select_voiced_counts
from sepi_tpu_torch.utils import kaldi_io as tkio

torch.set_num_threads(2)

LOG_TOL = 1e-3


def _audio(seed, n=2 * 8000 + 321):
    rng = np.random.default_rng(seed)
    samples = (rng.normal(size=(3, n)) * 2000).astype(np.float32)
    lengths = np.array([n, int(0.55 * n), 400], np.int32)
    return samples, lengths


CASES = {
    "log": dict(dither=0.0),
    "linear": dict(dither=0.0, use_log_fbank=False),
    "log_dithered": dict(dither=1.0),
    "linear_dithered": dict(dither=1.0, use_log_fbank=False),
    "wide16k_snip": dict(dither=0.0, sample_rate=16000, num_mel_bins=40, low_freq=40.0,
                         high_freq=-200.0, snip_edges=True),
    "no_raw_energy": dict(dither=0.0, raw_energy=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fbank_matches_reference(case):
    kw = CASES[case]
    samples, lengths = _audio(len(case))
    seeds = utt_seeds(["a", "b", "c"], base_seed=3)
    np.testing.assert_array_equal(seeds, jutt_seeds(["a", "b", "c"], base_seed=3))
    ref, mref = jf.FeatureExtractor(jcfg.FrontendConfig(**kw)).fbank(samples, lengths,
                                                                      utt_seeds=seeds)
    got, mask = tf.FeatureExtractor(tcfg.FrontendConfig(**kw), device="cpu").fbank(
        samples, lengths, utt_seeds=seeds)
    ref, mref = np.asarray(ref), np.asarray(mref)
    np.testing.assert_array_equal(mask.numpy(), mref)
    assert got.shape == ref.shape
    if kw.get("use_log_fbank", True):
        assert np.abs(got.numpy() - ref).max() <= LOG_TOL
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=LOG_TOL, atol=1e-6)


def test_fbank_dither_needs_seeds_and_functional_forms():
    samples, lengths = _audio(9)
    cfg = tcfg.FrontendConfig()
    plain, _ = tf.fbank(samples, lengths, tcfg.FrontendConfig(dither=0.0), device="cpu")
    unseeded, _ = tf.fbank(samples, lengths, cfg, device="cpu")
    np.testing.assert_array_equal(unseeded.numpy(), plain.numpy())
    dithered, _ = tf.fbank(samples, lengths, cfg, utt_seeds=[1, 2, 3], device="cpu")
    assert not np.array_equal(dithered.numpy(), plain.numpy())
    ref, _ = jf.fbank(samples, lengths, jcfg.FrontendConfig(dither=0.0))
    assert np.abs(plain.numpy() - np.asarray(ref)).max() <= LOG_TOL
    m1, _ = tf.mfcc(samples, lengths, tcfg.FrontendConfig(dither=0.0), device="cpu")
    m2, _ = tf.FeatureExtractor(tcfg.FrontendConfig(dither=0.0), device="cpu").mfcc(samples,
                                                                                      lengths)
    np.testing.assert_array_equal(m1.numpy(), m2.numpy())
    one, mask = tf.fbank(samples[0], None, tcfg.FrontendConfig(dither=0.0), device="cpu")
    assert one.ndim == 2 and mask.ndim == 1


@pytest.mark.parametrize("snip", [False, True])
@pytest.mark.parametrize("max_frames", [20, 300])
def test_raw_frames_match_reference(snip, max_frames):
    """Both of the reference's framing paths (exact gather below 32
    frames, gather-free slices above) against the port's one."""
    kw = dict(dither=0.0, snip_edges=snip)
    samples, lengths = _audio(5)
    ref, mref = jfr.raw_frames(jnp.asarray(samples), jnp.asarray(lengths),
                               jcfg.FrontendConfig(**kw), max_frames)
    got, mask = tfr.raw_frames(samples, lengths, tcfg.FrontendConfig(**kw), max_frames)
    mref = np.asarray(mref)
    np.testing.assert_array_equal(mask.numpy(), mref)
    np.testing.assert_array_equal(got.numpy()[mref], np.asarray(ref)[mref])


@pytest.mark.parametrize("kw", [dict(dither=0.0), dict(dither=1.0),
                                dict(dither=0.0, raw_energy=False, preemphasis=0.0),
                                dict(dither=1.0, remove_dc_offset=False, snip_edges=True)],
                         ids=["plain", "dithered", "no_raw_energy", "dithered_snip"])
def test_frame_signal_matches_reference(kw):
    samples, lengths = _audio(6)
    seeds = utt_seeds(["x", "y", "z"])
    max_frames = int(tfr.num_frames(samples.shape[1], tcfg.FrontendConfig(**kw)))
    wr, er, mr = jfr.frame_signal(jnp.asarray(samples), jnp.asarray(lengths),
                                  jcfg.FrontendConfig(**kw), max_frames,
                                  seeds=jnp.asarray(seeds))
    wg, eg, mg = tfr.frame_signal(samples, lengths, tcfg.FrontendConfig(**kw), max_frames,
                                  seeds=seeds)
    mr = np.asarray(mr)
    np.testing.assert_array_equal(mg.numpy(), mr)
    wr, er = np.asarray(wr)[mr], np.asarray(er)[mr]
    np.testing.assert_allclose(wg.numpy()[mr], wr, rtol=1e-5, atol=1e-5 * np.abs(wr).max())
    np.testing.assert_allclose(eg.numpy()[mr], er, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fill", [-1, 7])
def test_select_voiced_counts_equals_reference(fill):
    rng = np.random.default_rng(fill + 10)
    values = rng.integers(0, 50, size=(4, 37)).astype(np.int32)
    voiced = rng.random((4, 37)) < 0.6
    voiced[3] = False
    got, mask = select_voiced_counts(torch.from_numpy(values), torch.from_numpy(voiced), fill)
    ref, mref = jselect_counts(jnp.asarray(values), jnp.asarray(voiced), fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mref))
    g1, m1 = select_voiced_counts(torch.from_numpy(values[0]), torch.from_numpy(voiced[0]), fill)
    r1, n1 = jselect_counts(jnp.asarray(values[0]), jnp.asarray(voiced[0]), fill)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(n1))


def _int_ark(entries) -> bytes:
    out = io.BytesIO()
    for key, v in entries.items():
        out.write(key.encode() + b" \x00B\x04" + struct.pack("<i", len(v)))
        out.write(np.asarray(v, "<i4").tobytes())
    return out.getvalue()


def _alignments(seed, n=5):
    rng = np.random.default_rng(seed)
    return {f"utt{seed}_{i}": rng.integers(0, 4000, size=rng.integers(0, 60)).astype(np.int32)
            for i in range(n)}


def _same(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def test_alignment_archives_match_reference(tmp_path):
    ali1, ali2 = _alignments(1), _alignments(2)
    with gzip.open(tmp_path / "ali.1.gz", "wb") as f:
        f.write(_int_ark(ali1))
    with gzip.open(tmp_path / "ali.2.gz", "wb") as f:
        f.write(_int_ark(ali2))
    (tmp_path / "plain.ark").write_bytes(_int_ark(ali1))
    for name in ("ali.1.gz", "plain.ark"):
        got = tkio.read_ali_ark(str(tmp_path / name))
        _same(got, jkio.read_ali_ark(str(tmp_path / name)))
        _same(got, ali1)
    merged = tkio.read_ali_dir(str(tmp_path))
    _same(merged, jkio.read_ali_dir(str(tmp_path)))
    assert len(merged) == len(ali1) + len(ali2)
    with pytest.raises(FileNotFoundError):
        tkio.read_ali_dir(str(tmp_path / "missing"))
    # the archives the port's own writer produces read the same way
    with tkio.ArkWriter(str(tmp_path / "w.ark")) as w:
        for k, v in ali2.items():
            w.put_int_vector(k, v)
    with open(tmp_path / "w.ark", "rb") as f:
        _same(dict(tkio.iter_int_vector_ark(f)), ali2)


@pytest.mark.parametrize("corrupt", ["negative", "overlong", "text", "size_byte", "garbage"])
def test_corrupt_alignment_archives_raise_in_both(corrupt):
    good = _int_ark({"u1": np.arange(5, dtype=np.int32)})
    bad = {
        "negative": good[:7] + struct.pack("<i", -3) + good[11:],
        "overlong": good[:7] + struct.pack("<i", 99) + good[11:],
        "text": b"u1 [ 1 2 3 ]\n",
        "size_byte": good[:6] + b"\x08" + good[7:],
        "garbage": good + b"trailing",
    }[corrupt]
    for mod in (tkio, jkio):
        with pytest.raises(ValueError):
            dict(mod.iter_int_vector_ark(io.BytesIO(bad)))


def test_read_feats_scp_matches_reference(tmp_path):
    rng = np.random.default_rng(4)
    feats = {f"u{i}": rng.normal(size=(10 + i, 6)).astype(np.float32) for i in range(4)}
    ark, scp = str(tmp_path / "feats.ark"), str(tmp_path / "feats.scp")
    with tkio.ArkWriter(ark, scp) as w:
        for i, (k, v) in enumerate(feats.items()):
            (w.put_compressed_matrix if i % 2 else w.put_matrix)(k, v)
    got, ref = tkio.read_feats_scp(scp), jkio.read_feats_scp(scp)
    _same(got, ref)
    np.testing.assert_array_equal(got["u0"], feats["u0"])
    assert os.path.getsize(ark) > 0
