"""Port parity, end to end: the s5 aligner path.

make_phonetic_corpus -> prepare_features_phonetic -> run_s5 ->
select_voiced_ali in both packages on the CPU.  The corpus must be
byte-identical; the features are compared undithered (the reference's
CPU default dithers per frame, its and the port's main path the
waveform); run_s5 is fed the same numpy features in both packages and
must reach the same senone inventory and the same label on at least 99%
of frames (near-ties in fp32 emissions may move a boundary frame).
"""

import numpy as np
import pytest
import torch

from sepi_tpu.config import AlignConfig as JAlign
from sepi_tpu.config import FrontendConfig as JFrontend
from sepi_tpu.data import make_phonetic_corpus as j_corpus
from sepi_tpu.recipes import pipeline as jp
from sepi_tpu.recipes.s5 import run_s5 as j_run_s5
from sepi_tpu_torch.config import AlignConfig, FrontendConfig
from sepi_tpu_torch.data import make_phonetic_corpus
from sepi_tpu_torch.recipes import pipeline as tp
from sepi_tpu_torch.recipes.s5 import run_s5, select_voiced_ali

torch.set_num_threads(2)

SMALL = dict(num_leaves=40, mono_iters=2, refine_iters=1, min_count=30.0)


@pytest.mark.parametrize("kw", [
    dict(num_speakers=3, utts_per_speaker=2, seed=9),
    dict(num_speakers=2, utts_per_speaker=2, seed=4, words_per_utt=(3, 5), f0_jitter=0.1,
         noise_snr_db=(10.0, 20.0), channel_strength=0.3, phone_seed=2, spk_prefix="x"),
])
def test_phonetic_corpus_bit_equal(kw):
    jc, tc = j_corpus(**kw), make_phonetic_corpus(**kw)
    assert jc.transcripts == tc.transcripts
    assert jc.lexicon.phones == tc.lexicon.phones and jc.lexicon.pron == tc.lexicon.pron
    assert jc.dataset.utt_ids == tc.dataset.utt_ids
    assert [(t.model, t.test, t.target) for t in jc.trials] == [
        (t.model, t.test, t.target) for t in tc.trials]
    for u in jc.audio:
        assert jc.audio[u].dtype == tc.audio[u].dtype == np.float32
        np.testing.assert_array_equal(jc.audio[u], tc.audio[u])


@pytest.fixture(scope="module")
def corpus():
    return make_phonetic_corpus(num_speakers=4, utts_per_speaker=4, seed=9)


@pytest.fixture(scope="module")
def feats(corpus):
    j = jp.prepare_features_phonetic(corpus.audio, JFrontend(dither=0.0))
    t = tp.prepare_features_phonetic(corpus.audio, FrontendConfig(dither=0.0), device="cpu")
    return j, t


def test_prepare_features_phonetic_parity(corpus, feats):
    j, t = feats
    assert sorted(t.full) == sorted(j.full) == sorted(corpus.audio)
    for u in j.full:
        assert t.full[u].shape == j.full[u].shape
        assert np.abs(t.full[u] - j.full[u]).max() <= 1e-3, u
        np.testing.assert_array_equal(t.voiced[u], j.voiced[u])
        np.testing.assert_array_equal(t.nosil[u], t.full[u][t.voiced[u]])
    nos = tp.prepare_features_nosil({u: corpus.audio[u] for u in list(corpus.audio)[:3]},
                                    FrontendConfig(dither=0.0), device="cpu")
    for u in nos:
        np.testing.assert_array_equal(nos[u], t.nosil[u])


def test_run_s5_parity_on_shared_features(corpus, feats):
    full = feats[0].full  # one feature set for both packages
    j = j_run_s5(full, corpus.transcripts, corpus.lexicon, JAlign(**SMALL))
    t = run_s5(full, corpus.transcripts, corpus.lexicon, AlignConfig(**SMALL), device="cpu")
    assert t.num_senones == j.num_senones > len(corpus.lexicon.phones) * 3
    np.testing.assert_array_equal(t.aligner.tree.dense_table(), j.aligner.tree.dense_table())
    same = sum(int(np.sum(t.alignments[u] == j.alignments[u])) for u in full)
    total = sum(len(a) for a in j.alignments.values())
    assert same / total >= 0.99, same / total
    assert len(t.frames_shifted) == SMALL["refine_iters"]


def test_run_s5_lda_mllt_fmllr_covers_corpus(corpus, feats):
    _, t = feats
    spk = {u.utt_id: u.spk_id for u in corpus.dataset}
    cfg = AlignConfig(lda_mllt=True, lda_mllt_dim=12, mllt_iters=1, fmllr=True,
                      fmllr_min_beta=50.0, **SMALL)
    res = run_s5(t.full, corpus.transcripts, corpus.lexicon, cfg, utt2spk=spk, device="cpu")
    assert res.lda_mllt.shape == (12, (2 * cfg.splice_context + 1) * 23)
    assert sorted(res.fmllr) == sorted(set(spk.values()))
    for w in res.fmllr.values():
        assert w.shape == (12, 13) and np.isfinite(w).all()
    assert sorted(res.alignments) == sorted(t.full)
    for u, a in res.alignments.items():
        assert len(a) == t.full[u].shape[0] == len(res.phone_alignments[u])
        assert 0 <= a.min() and a.max() < res.num_senones
    ali = select_voiced_ali(res.alignments, t.voiced)
    for u in ali:
        assert len(ali[u]) == t.nosil[u].shape[0]
    with pytest.raises(ValueError):
        select_voiced_ali({"u": np.ones(3, np.int32)}, {"u": np.ones(5, bool)})
    with pytest.raises(ValueError, match="utt2spk"):
        run_s5(t.full, corpus.transcripts, corpus.lexicon, cfg, device="cpu")


def test_run_s5_defaults_to_cuda(corpus, feats, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_s5(feats[1].full, corpus.transcripts, corpus.lexicon, AlignConfig(**SMALL))
    with pytest.raises(RuntimeError, match="cuda"):
        tp.prepare_features_phonetic(corpus.audio)
