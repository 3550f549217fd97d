"""The port's augmentation against the JAX package's: the draw tables, the
noise and babble mixes bit for bit, the reverberation within a tolerance
relative to the signal's RMS (a float32 FFT in torch against the
reference's), and the eager and lazy datasets against each other and the
reference."""

import dataclasses

import numpy as np
import pytest
import torch

from sepi_tpu.data import augment as ref_aug
from sepi_tpu.data.manifest import Dataset as RefDataset
from sepi_tpu.data.manifest import Utterance as RefUtterance
from sepi_tpu_torch.data import augment as aug
from sepi_tpu_torch.data.manifest import Dataset, Utterance

torch.set_num_threads(2)

# max |port - reference| of a reverberated copy over the dry signal's RMS:
# two float32 FFTs of 2^13-2^14 points round apart by about 1e-6 of it
REVERB_RTOL = 1e-5


def _setup(n_utts=4, seed=0):
    rng = np.random.default_rng(seed)
    rows = [dict(utt_id=f"s{i % 2}-u{i}", spk_id=f"s{i % 2}", wav=f"synth:s{i % 2}-u{i}")
            for i in range(n_utts)]
    audio = {r["utt_id"]: (rng.standard_normal(6000 + 900 * i) * 2000).astype(np.float32)
             for i, r in enumerate(rows)}
    rirs = [aug.synthetic_rir(seed=3), aug.synthetic_rir(rt60=0.5, seed=4)]
    noises = {"noise": [(rng.standard_normal(9000) * 500).astype(np.float32) for _ in range(3)],
              "music": [(rng.standard_normal(4000) * 700).astype(np.float32) for _ in range(2)],
              "babble": [(rng.standard_normal(7000) * 900).astype(np.float32)
                         for _ in range(5)]}
    return (Dataset([Utterance(**r) for r in rows], "d"),
            RefDataset([RefUtterance(**r) for r in rows], "d"), audio, rirs, noises)


def _rel(a, b, dry):
    return float(np.abs(a - b).max() / np.sqrt(np.mean(np.square(dry, dtype=np.float64))))


def test_plans_equal_the_reference():
    ds, ref_ds, _, rirs, noises = _setup(6)
    for seed in (0, 7):
        plans = aug.plan_augments(ds, rirs, noises, seed=seed)
        ref = ref_aug.plan_augments(ref_ds, rirs, noises, seed=seed)
        assert [dataclasses.astuple(p) for p in plans] == [dataclasses.astuple(p) for p in ref]
    assert aug.synthetic_rir(seed=9).tobytes() == ref_aug.synthetic_rir(seed=9).tobytes()


@pytest.mark.parametrize("which", [0, 1])
def test_reverberate_within_tolerance(which):
    _, _, audio, rirs, _ = _setup()
    x = audio["s1-u1"]
    got = aug.reverberate(x, rirs[which], device="cpu")
    ref = ref_aug.reverberate(x, rirs[which])
    assert got.dtype == np.float32 and got.shape == x.shape
    assert _rel(got, ref, x) <= REVERB_RTOL
    # the direct-path shift and power normalisation hold
    assert np.isclose(np.mean(np.square(got, dtype=np.float64)),
                      np.mean(np.square(x, dtype=np.float64)), rtol=1e-4)


def test_noise_and_babble_are_bit_identical():
    _, _, audio, _, noises = _setup()
    x = audio["s0-u0"]
    for snr in (0.0, 13.0):
        got = aug.mix_noise(x, noises["noise"][1], snr, np.random.default_rng(5))
        ref = ref_aug.mix_noise(x, noises["noise"][1], snr, np.random.default_rng(5))
        assert got.tobytes() == ref.tobytes()
        got = aug.mix_babble(x, noises["babble"][:4], snr, np.random.default_rng(6))
        ref = ref_aug.mix_babble(x, noises["babble"][:4], snr, np.random.default_rng(6))
        assert got.tobytes() == ref.tobytes()
    # a short noise is tiled to the signal's length
    assert aug.mix_noise(x, noises["music"][0][:100], 5.0).shape == x.shape


def test_eager_lazy_and_reference_datasets_agree():
    ds, ref_ds, audio, rirs, noises = _setup()
    eager_ds, eager = aug.augment_dataset(ds, audio, rirs, noises, seed=2, device="cpu")
    lazy_ds, lazy = aug.lazy_augment_dataset(ds, audio, rirs, noises, seed=2, device="cpu")
    ref_ds2, ref = ref_aug.augment_dataset(ref_ds, audio, rirs, noises, seed=2)
    _, ref_lazy = ref_aug.lazy_augment_dataset(ref_ds, audio, rirs, noises, seed=2)
    assert eager_ds.name == lazy_ds.name == ref_ds2.name == "d_aug"
    rows = [(u.utt_id, u.spk_id, u.wav, u.uniq_id) for u in eager_ds]
    assert rows == [(u.utt_id, u.spk_id, u.wav, u.uniq_id) for u in lazy_ds]
    assert rows == [(u.utt_id, u.spk_id, u.wav, u.uniq_id) for u in ref_ds2]
    assert list(eager) == list(lazy) == list(ref) and len(eager) == 4 * len(ds)
    for a in reversed(list(lazy)):  # any realisation order gives the eager samples
        assert lazy[a].tobytes() == eager[a].tobytes()
        assert lazy.num_samples(a) == len(eager[a])
        dry = audio[a.rsplit("-", 1)[0]]
        if a.endswith("-reverb"):
            assert _rel(eager[a], ref[a], dry) <= REVERB_RTOL
        else:
            assert eager[a].tobytes() == ref[a].tobytes()
    assert lazy.manifest_fingerprint() == ref_lazy.manifest_fingerprint()
    keep = set(list(lazy)[::3])
    sub, ref_sub = lazy.subset(keep), ref_lazy.subset(keep)
    assert list(sub) == list(ref_sub)
    assert sub.manifest_fingerprint() == ref_sub.manifest_fingerprint()
