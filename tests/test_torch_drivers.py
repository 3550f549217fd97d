"""The port's recipe drivers on the CPU (tiny widths): `_finish` against
the JAX package's on the same embeddings (scores, report and every file
it writes), `run_v2` end to end with augmentation, adaptation, stage
caching and held-out diagnostics, the stale-cache fingerprint, and the
trainer-to-extraction chain of `extract_and_score`."""

import json
import os

import numpy as np
import pytest
import torch

from sepi_tpu.config import BackendConfig as RefBackendConfig
from sepi_tpu.data.manifest import Dataset as RefDataset
from sepi_tpu.data.manifest import Trial as RefTrial
from sepi_tpu.data.manifest import Utterance as RefUtterance
from sepi_tpu.recipes import drivers as ref_drivers
from sepi_tpu_torch.config import BackendConfig, ChunkConfig, ExtractConfig, OptimizerConfig, TrainConfig
from sepi_tpu_torch.data import make_synthetic_corpus
from sepi_tpu_torch.data.augment import synthetic_rir
from sepi_tpu_torch.metrics.report import metadata_condition
from sepi_tpu_torch.models import XVectorConfig
from sepi_tpu_torch.models.tdnn import TdnnSpec
from sepi_tpu_torch.recipes import drivers, extract_and_score, train_xvector_model
from sepi_tpu_torch.recipes.drivers import AugmentOptions, run_v2
from sepi_tpu_torch.utils import kaldi_models, read_scp, read_vector

torch.set_num_threads(2)

TINY_SPECS = (
    TdnnSpec(24, (-2, -1, 0, 1, 2)),
    TdnnSpec(24, (-2, 0, 2)),
    TdnnSpec(24, (-3, 0, 3)),
    TdnnSpec(24, (0,)),
    TdnnSpec(64, (0,)),
)
TRAIN_CFG = TrainConfig(
    optimizer=OptimizerConfig(initial_lr=0.02, final_lr=0.005, proportional_shrink=0.5),
    chunks=ChunkConfig(min_chunk_len=50, max_chunk_len=100, num_buckets=2),
    batch_size=24,
)
EXTRACT_CFG = ExtractConfig(chunk_size=300, batch_size=16)
MODEL_CFG = XVectorConfig(feat_dim=23, num_speakers=6, frame_specs=TINY_SPECS, embed_dim=32)
AUG_KINDS = ("-reverb", "-noise", "-music", "-babble")


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic_corpus(num_speakers=6, utts_per_speaker=5, duration_sec=3.0, seed=55)


def _enroll(corpus):
    return {s: us[:1] for s, us in corpus.dataset.spk2utt.items()}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("adapt", [False, True])
def test_finish_equals_the_reference(tmp_path, corpus, adapt):
    """One embeddings dict through both packages' `_finish`: scores to
    1e-9 relative, the same report, and every file byte for byte."""
    rng = np.random.default_rng(5)
    spk_mean = {s: rng.standard_normal(16) for s in corpus.dataset.speakers}
    embs = {u.utt_id: (spk_mean[u.spk_id] + 0.7 * rng.standard_normal(16)).astype(np.float32)
            for u in corpus.dataset}
    adapt_embs = rng.standard_normal((12, 16)).astype(np.float32) if adapt else None
    ref_ds = RefDataset([RefUtterance(u.utt_id, u.spk_id) for u in corpus.dataset], "d")
    ref_trials = [RefTrial(t.model, t.test, t.target) for t in corpus.trials]
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    got = drivers._finish(embs, corpus.dataset, corpus.trials, _enroll(corpus),
                          BackendConfig(lda_dim=8), adapt_embs, None, None, str(port_dir))
    ref = ref_drivers._finish(embs, ref_ds, ref_trials, _enroll(corpus),
                              RefBackendConfig(lda_dim=8), adapt_embs, None, None, str(ref_dir))
    assert got.report == ref.report
    assert sorted(got.scores) == sorted(ref.scores)
    s = np.array([got.scores[k] for k in ref.scores])
    r = np.array([ref.scores[k] for k in ref.scores])
    assert np.all(np.abs(s - r) <= 1e-9 * np.maximum(np.abs(r), 1e-300))
    for name in ("xvector.ark", "det_pooled.txt", "det_pooled.svg", "backend/mean.vec",
                 "backend/transform.mat", "backend/plda"):
        assert _read(port_dir / name) == _read(ref_dir / name), name
    scp = [line.split()[0] for line in open(port_dir / "xvector.scp")]
    assert scp == sorted(embs)
    assert set(got.seconds) == {"files", "backend"}


def test_run_v2_with_augmentation_adaptation_and_cache(tmp_path, corpus, capsys):
    """v2 stage-2 semantics (augmented copies subset and combined with the
    clean set), PLDA adaptation and condition splits; the Kaldi-format
    outputs read back equal to the run's own; a second call hits the
    feature cache."""
    rng = np.random.default_rng(123)
    noise_pool = [(rng.normal(size=(16000,)) * 800).astype(np.float32) for _ in range(4)]
    speech_pool = [(rng.normal(size=(12000,)) * 1500).astype(np.float32) for _ in range(8)]
    opts = AugmentOptions(
        rirs=[synthetic_rir(seed=3)],
        noises={"noise": noise_pool, "music": noise_pool, "babble": speech_pool},
        subset=40,
    )
    test_utts = {u.utt_id: u.replace(meta=(("lang", "tgl" if i % 2 else "yue"),))
                 for i, u in enumerate(corpus.dataset)}
    wd = str(tmp_path)
    kw = dict(model_cfg=MODEL_CFG, train_cfg=TRAIN_CFG, extract_cfg=EXTRACT_CFG,
              num_steps=100, augments=opts, adapt_dataset=corpus.dataset,
              adapt_audio=corpus.audio, condition_fn=metadata_condition(test_utts, "lang"),
              device="cpu")
    res = run_v2(corpus.dataset, corpus.audio, corpus.dataset, {}, corpus.trials,
                 _enroll(corpus), wd, **kw)
    assert res.pooled.eer < 0.25
    assert "pooled" in res.report and any(c.startswith("lang:") for c in res.conditions)
    assert {"augment", "features", "train", "extract", "backend", "files"} <= set(res.seconds)
    table = dict(read_scp(os.path.join(wd, "xvector.scp")))
    n_aug = sum(1 for u in table if any(k in u for k in AUG_KINDS))
    assert n_aug == 40 and len(table) == len(corpus.dataset) + 40
    emb = read_vector(*table[corpus.dataset.utt_ids[0]])
    assert emb.shape == (32,) and np.all(np.isfinite(emb))
    plda = kaldi_models.read_plda(os.path.join(wd, "backend", "plda"))
    # LDA to min(lda_dim, speakers - 1) = 5 dimensions
    assert np.all(np.isfinite(plda.transform)) and plda.mean.shape == (5,)
    assert kaldi_models.read_kaldi_matrix_file(
        os.path.join(wd, "backend", "transform.mat")).shape == (5, 32)
    assert os.path.getsize(os.path.join(wd, "det_pooled.svg")) > 0
    assert "[feats_train] running" in capsys.readouterr().out

    def train_records():
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            return sum(json.loads(line)["task"] == "xvec" for line in f)

    before = train_records()
    again = run_v2(corpus.dataset, corpus.audio, corpus.dataset, {}, corpus.trials,
                   _enroll(corpus), wd, **kw)
    out = capsys.readouterr().out
    assert "[feats_train] cached" in out and "[feats_eval] cached" in out
    # resumed at the last checkpoint: no training step ran again
    assert train_records() == before and np.isfinite(again.pooled.eer)


def test_run_v2_heldout_diagnostics_and_combine(tmp_path, corpus):
    """The reference never trains blind: a valid:xvec series at globally
    monotone steps, checkpoints, and one combine record whose combined
    held-out objf is no worse than the last checkpoint's."""
    wd = str(tmp_path)
    run_v2(corpus.dataset, corpus.audio, corpus.dataset, {}, corpus.trials, _enroll(corpus),
           wd, model_cfg=MODEL_CFG, train_cfg=TRAIN_CFG, extract_cfg=EXTRACT_CFG,
           num_steps=220, device="cpu")
    recs = [json.loads(line) for line in open(os.path.join(wd, "metrics.jsonl"))]
    valid = [r for r in recs if r["task"] == "valid:xvec"]
    assert len(valid) >= 2 and all(np.isfinite(r["objf"]) for r in valid)
    steps = [r["step"] for r in valid]
    assert steps == sorted(steps) and steps[-1] > TRAIN_CFG.checkpoint_every
    assert os.listdir(os.path.join(wd, "ckpt"))
    combine = [r for r in recs if r["task"] == "combine"]
    assert len(combine) == 1
    assert combine[0]["objf_combined"] >= combine[0]["objf_last"] - 1e-9


def test_audio_fingerprint_busts_stale_feature_cache():
    """Identical utt ids with other samples give another stage key; a
    tail-only change is caught too; the strings are the reference's."""
    rng = np.random.default_rng(123)
    a = {"u1-noise": (rng.normal(size=(8000,)) * 100).astype(np.float32)}
    b = {"u1-noise": (rng.normal(size=(8000,)) * 100).astype(np.float32)}
    fp = drivers._audio_fingerprint
    assert fp(a) != fp(b)
    assert fp(a) == fp({k: v.copy() for k, v in a.items()}) == ref_drivers._audio_fingerprint(a)
    c = {k: v.copy() for k, v in a.items()}
    c["u1-noise"][-1] += 1.0
    assert fp(a) != fp(c)


def test_extract_and_score_takes_the_trainers_state(corpus):
    """train_xvector_model's (model, TrainState) chains into
    extract_and_score: the same embeddings as the state_dict form and as
    the model's own weights; a mesh is refused."""
    from sepi_tpu_torch.models import XVector
    from sepi_tpu_torch.recipes import prepare_features_nosil
    from sepi_tpu_torch.train import TrainState

    nosil = prepare_features_nosil(corpus.audio, device="cpu")
    model, state, _ = train_xvector_model(nosil, corpus.dataset, MODEL_CFG, TRAIN_CFG, 4,
                                          num_heldout_utts=0, device="cpu")
    assert isinstance(state, TrainState)
    fresh = XVector(MODEL_CFG).eval()
    by_state = extract_and_score(fresh, state, nosil, EXTRACT_CFG, MODEL_CFG.min_frames,
                                 device="cpu")
    by_dict = extract_and_score(XVector(MODEL_CFG).eval(), model.state_dict(), nosil,
                                EXTRACT_CFG, MODEL_CFG.min_frames, device="cpu")
    own = extract_and_score(model, None, nosil, EXTRACT_CFG, MODEL_CFG.min_frames, device="cpu")
    for u in nosil:
        np.testing.assert_array_equal(by_state[u], by_dict[u])
        np.testing.assert_array_equal(by_state[u], own[u])
    with pytest.raises(NotImplementedError, match="mesh"):
        extract_and_score(model, state, nosil, EXTRACT_CFG, MODEL_CFG.min_frames,
                          mesh=object(), device="cpu")
