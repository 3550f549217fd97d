"""The port's phonetic drivers on the CPU (tiny widths): `run_v3` on
given alignments, `run_v4` with transcripts and lexicon (the s5 stage
runs inside the driver), `run_v5` from v4's cached s5 stage, and the
held-out and combine records of the multitask run."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from sepi_tpu_torch.config import AlignConfig, ChunkConfig, ExtractConfig, OptimizerConfig, TrainConfig
from sepi_tpu_torch.data import make_phonetic_corpus
from sepi_tpu_torch.models import AdaptedConfig, AmConfig, CombinedConfig, MultitaskConfig
from sepi_tpu_torch.models.tdnn import TdnnSpec
from sepi_tpu_torch.recipes import prepare_features_phonetic, run_s5, select_voiced_ali
from sepi_tpu_torch.recipes.drivers import run_v3, run_v4, run_v5
from sepi_tpu_torch.utils import read_scp

torch.set_num_threads(2)

TRAIN_CFG = TrainConfig(
    optimizer=OptimizerConfig(initial_lr=0.02, final_lr=0.005, proportional_shrink=0.5),
    chunks=ChunkConfig(min_chunk_len=50, max_chunk_len=100, num_buckets=2),
    batch_size=24, am_batch_size=64,
)
EXTRACT_CFG = ExtractConfig(min_chunk_size=25, chunk_size=300, batch_size=16)
ALIGN_CFG = AlignConfig(num_leaves=40, mono_iters=3, refine_iters=2, min_count=30.0)
WIDTHS = dict(num_speakers=6, embed_dim=24, hidden_dim=16, pool_dim=32)


def _tiny_am(num_senones):
    return AmConfig(
        feat_dim=23, num_senones=num_senones,
        specs=(TdnnSpec(16, (-2, -1, 0, 1, 2)), TdnnSpec(16, (-1, 0, 1)),
               TdnnSpec(16, (-1, 0, 1)), TdnnSpec(16, (-3, 0, 3)), TdnnSpec(8, (-6, -3, 0))),
    )


@pytest.fixture(scope="module")
def corpus():
    return make_phonetic_corpus(num_speakers=6, utts_per_speaker=5, words_per_utt=(4, 6),
                                seed=21)


def _enroll(corpus):
    return {s: us[:1] for s, us in corpus.dataset.spk2utt.items()}


def _records(wd):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_v3_on_given_alignments(tmp_path, corpus):
    """The exp/tri6a_4k_ali analog as an input: held-out valid:am and
    valid:xvec series, a combine record, an embedding per utterance."""
    pf = prepare_features_phonetic(corpus.audio, device="cpu")
    s5 = run_s5(pf.full, corpus.transcripts, corpus.lexicon, ALIGN_CFG, device="cpu",
                utt2spk={u.utt_id: u.spk_id for u in corpus.dataset})
    ali = select_voiced_ali(s5.alignments, pf.voiced)
    wd = str(tmp_path)
    res = run_v3(corpus.dataset, corpus.audio, {}, corpus.trials, _enroll(corpus), wd,
                 alignments=ali, model_cfg=MultitaskConfig(num_senones=s5.num_senones, **WIDTHS),
                 train_cfg=TRAIN_CFG, extract_cfg=EXTRACT_CFG, num_steps=140, device="cpu")
    assert res.pooled.eer < 0.2 and res.pooled.num_target > 0
    recs = _records(wd)
    for task in ("valid:xvec", "valid:am", "combine"):
        assert [r for r in recs if r["task"] == task], task
    assert set(dict(read_scp(os.path.join(wd, "xvector.scp")))) == set(corpus.dataset.utt_ids)
    assert "s5" not in res.seconds and {"features", "train", "extract"} <= set(res.seconds)


def test_run_v4_and_v5_with_the_s5_stage(tmp_path, corpus, capsys):
    """v4 runs the s5 aligner inside the driver; v5 finds v4's s5 stage
    files in its own workdir and reuses them (the --stage resume)."""
    v4, v5 = str(tmp_path / "v4"), str(tmp_path / "v5")
    res4 = run_v4(corpus.dataset, corpus.audio, {}, corpus.trials, _enroll(corpus), v4,
                  transcripts=corpus.transcripts, lexicon=corpus.lexicon, align_cfg=ALIGN_CFG,
                  am_cfg=_tiny_am(40), model_cfg=AdaptedConfig(am=_tiny_am(40), **WIDTHS),
                  train_cfg=TRAIN_CFG, extract_cfg=EXTRACT_CFG, am_steps=50, num_steps=100,
                  device="cpu")
    assert res4.pooled.eer < 0.35
    assert "[s5_feats_ali] running" in capsys.readouterr().out
    assert {"features", "s5", "am", "train", "extract", "backend", "files"} <= set(res4.seconds)
    os.makedirs(v5)
    for f in os.listdir(v4):
        if f.startswith(("s5_feats_ali-", "feats_")):
            shutil.copy(os.path.join(v4, f), v5)
    res5 = run_v5(corpus.dataset, corpus.audio, {}, corpus.trials, _enroll(corpus), v5,
                  transcripts=corpus.transcripts, lexicon=corpus.lexicon, align_cfg=ALIGN_CFG,
                  am_cfg=_tiny_am(40),
                  model_cfg=CombinedConfig(num_senones=40, am=_tiny_am(40), **WIDTHS),
                  train_cfg=TRAIN_CFG, extract_cfg=EXTRACT_CFG, am_steps=50, num_steps=100,
                  device="cpu")
    out = capsys.readouterr().out
    assert "[s5_feats_ali] cached" in out and "[feats_eval] cached" in out
    assert res5.pooled.eer < 0.35
    for wd in (v4, v5):
        assert os.path.exists(os.path.join(wd, "backend", "plda"))
        assert [r for r in _records(wd) if r["task"] == "combine"]


def test_phonetic_drivers_need_alignments(tmp_path, corpus):
    with pytest.raises(ValueError, match="alignments"):
        run_v3(corpus.dataset, corpus.audio, {}, corpus.trials, _enroll(corpus),
               str(tmp_path), train_cfg=TRAIN_CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        run_v5(corpus.dataset, corpus.audio, {}, corpus.trials, _enroll(corpus),
               str(tmp_path), mesh=object(), device="cpu")
    assert not np.any([f.startswith("feats_train") for f in os.listdir(tmp_path)])
