"""The port's corpus-v2 generator against the JAX package's: the same
call gives bit-identical audio, the same transcripts, lexicon, manifest
and trials."""

import numpy as np
import pytest
import torch

from sepi_tpu.data.synthetic import make_phonetic_corpus_v2 as ref_make
from sepi_tpu_torch.data.synthetic import make_phonetic_corpus_v2

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(num_speakers=3, utts_per_speaker=3, seed=4),
    # the smoke run's train settings (the gauntlet's corpus-v2 domain)
    dict(num_speakers=2, utts_per_speaker=3, seed=100, spk_prefix="trn", words_per_utt=(3, 7),
         tilt_strength=0.06, f0_jitter=0.12, noise_snr_db=(8.0, 20.0),
         channel_strength=0.15, channel_seed=500, long_utt_frac=0.25, phone_seed=11),
    dict(num_speakers=2, utts_per_speaker=2, seed=101, spk_prefix="evl", phone_seed=11,
         tilt_strength=0.0, long_utt_frac=0.0, channel_strength=0.15),
])
def test_corpus_v2_is_bit_identical(kw):
    got, ref = make_phonetic_corpus_v2(**kw), ref_make(**kw)
    assert list(got.audio) == list(ref.audio)
    for u in ref.audio:
        assert got.audio[u].dtype == np.float32
        assert got.audio[u].tobytes() == ref.audio[u].tobytes()
    assert got.transcripts == ref.transcripts
    assert got.lexicon.pron == ref.lexicon.pron and got.lexicon.phones == ref.lexicon.phones
    assert got.dataset.name == ref.dataset.name
    assert [(u.utt_id, u.spk_id, u.wav, u.num_samples, u.duration) for u in got.dataset] == \
        [(u.utt_id, u.spk_id, u.wav, u.num_samples, u.duration) for u in ref.dataset]
    assert [(t.model, t.test, t.target) for t in got.trials] == \
        [(t.model, t.test, t.target) for t in ref.trials]
    assert got.corpus.sample_rate == ref.corpus.sample_rate == 8000
