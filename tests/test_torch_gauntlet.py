"""`sepi_tpu_torch.recipes.gauntlet` against `sepi_tpu.recipes.gauntlet`.

Held on the CPU: the scale presets field for field (and their stage-cache
keys); `make_gauntlet_data` at `CI_SCALE` sample for sample (audio,
transcripts, lexicon, trials, enrollment); the paired speaker bootstrap,
the weighted EER/minDCF and `format_table` equal for the same scores and
seed; one `run_gauntlet` of all five systems at a tiny scale finishing
with finite EERs, its s5 stage loaded from the cache on a second call.
The calibrated pins (v2 in (5%, 30%), v5 at least 2 points below v2) are
a full-scale run's: smoke phase 12e holds them on the card.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from sepi_tpu.recipes import gauntlet as R
from sepi_tpu.utils.artifacts import config_key as ref_config_key
from sepi_tpu_torch.data.manifest import Trial
from sepi_tpu_torch.metrics.det import evaluate_scores
from sepi_tpu_torch.recipes import gauntlet as P
from sepi_tpu_torch.utils.artifacts import config_key

torch.set_num_threads(2)

PRESETS = ("CI_SCALE", "CI_SCALE_V2", "ADAPT_SCALE", "HW_SCALE", "HW_SCALE_V2")


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match(name):
    got, want = dataclasses.asdict(getattr(P, name)), dataclasses.asdict(getattr(R, name))
    assert got == want
    assert config_key([got]) == ref_config_key([want])
    port, ref = getattr(P, name), getattr(R, name)
    assert [dataclasses.asdict(s) for s in port.frame_specs()] == [
        dataclasses.asdict(s) for s in ref.frame_specs()]
    assert [dataclasses.asdict(s) for s in port.am_specs()] == [
        dataclasses.asdict(s) for s in ref.am_specs()]
    assert dataclasses.asdict(port.train_cfg()) == dataclasses.asdict(ref.train_cfg())
    assert dataclasses.asdict(port.extract_cfg()) == dataclasses.asdict(ref.extract_cfg())


def test_hw_scale_is_fullsize():
    assert [s.dim for s in P.HW_SCALE.frame_specs()] == [512, 512, 512, 512, 1500]
    assert P.HW_SCALE.embed_dim == 512 and P.HW_SCALE.mt_steps == 2 * P.HW_SCALE.steps
    assert P.HW_SCALE.num_train_speakers > 2 * P.CI_SCALE.num_train_speakers


def _corpus_equal(got, want):
    assert [dataclasses.asdict(u) for u in got.dataset] == [
        dataclasses.asdict(u) for u in want.dataset]
    assert set(got.audio) == set(want.audio)
    for u in want.audio:
        np.testing.assert_array_equal(got.audio[u], want.audio[u])
    assert got.transcripts == want.transcripts
    assert got.lexicon.pron == want.lexicon.pron and got.lexicon.phones == want.lexicon.phones


def test_gauntlet_data_matches_at_ci_scale():
    got, want = P.make_gauntlet_data(P.CI_SCALE), R.make_gauntlet_data(R.CI_SCALE)
    for part in ("train", "eval", "adapt"):
        _corpus_equal(getattr(got, part), getattr(want, part))
    assert [dataclasses.asdict(t) for t in got.trials] == [
        dataclasses.asdict(t) for t in want.trials]
    assert got.enroll_spk2utt == want.enroll_spk2utt
    # disjoint populations, trials on non-enrolled utterances only
    trn, evl = set(got.train.dataset.speakers), set(got.eval.dataset.speakers)
    assert not trn & evl and not trn & set(got.adapt.dataset.speakers)
    enrolled = {u for us in got.enroll_spk2utt.values() for u in us}
    assert all(t.test not in enrolled for t in got.trials)


def test_corpus_v2_gauntlet_data_matches():
    tiny = dataclasses.replace(P.CI_SCALE_V2, num_train_speakers=3, num_eval_speakers=3,
                               num_adapt_speakers=2, utts_per_speaker=3,
                               eval_utts_per_speaker=4)
    ref_tiny = dataclasses.replace(R.CI_SCALE_V2, **{
        f: getattr(tiny, f) for f in ("num_train_speakers", "num_eval_speakers",
                                      "num_adapt_speakers", "utts_per_speaker",
                                      "eval_utts_per_speaker")})
    got, want = P.make_gauntlet_data(tiny), R.make_gauntlet_data(ref_tiny)
    for part in ("train", "eval", "adapt"):
        _corpus_equal(getattr(got, part), getattr(want, part))
    assert got.enroll_spk2utt == want.enroll_spk2utt


def _fake_results(rng, trials, systems):
    """{system: result} with ``scores`` and ``pooled`` as RunResult has."""
    out = {}
    for i, name in enumerate(systems):
        scores = {(t.model, t.test): float(rng.normal(1.5 + 0.4 * i if t.target else 0.0))
                  for t in trials}
        tgt = np.array([scores[(t.model, t.test)] for t in trials if t.target])
        non = np.array([scores[(t.model, t.test)] for t in trials if not t.target])
        out[name] = types.SimpleNamespace(scores=scores, pooled=evaluate_scores(tgt, non))
    return out


def _trials(rng, n_spk=12, per_spk=6):
    utt2spk = {f"s{s}-u{u}": f"s{s}" for s in range(n_spk) for u in range(per_spk)}
    trials = [Trial(f"s{m}", utt, utt2spk[utt] == f"s{m}")
              for m in range(n_spk) for utt in utt2spk if rng.random() < 0.5]
    return trials, utt2spk


def test_bootstrap_and_weighted_metrics_match():
    rng = np.random.default_rng(0)
    trials, utt2spk = _trials(rng)
    results = _fake_results(rng, trials, ("v2", "v3", "v5"))
    # one system leaves a trial unscored: both compare the intersection
    results["v3"].scores.pop((trials[0].model, trials[0].test))
    pairs = [("v2", "v3"), ("v2", "v5")]
    got = P.paired_speaker_bootstrap(results, trials, utt2spk, pairs, n_boot=200, seed=3)
    want = R.paired_speaker_bootstrap(results, trials, utt2spk, pairs, n_boot=200, seed=3)
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
    assert [c.line() for c in got] == [c.line() for c in want] and len(got) == 2

    scores = rng.normal(size=300)
    targets = rng.random(300) < 0.2
    order = np.argsort(scores, kind="stable")
    weights = rng.integers(0, 4, 300).astype(np.float64)
    for name in ("_weighted_eer", "_weighted_min_dcf08"):
        assert getattr(P, name)(scores, targets, order, weights) == getattr(R, name)(
            scores, targets, order, weights)
    assert np.isnan(P._weighted_eer(scores, targets, order, np.zeros(300)))


def test_format_table_matches():
    rng = np.random.default_rng(1)
    trials, _ = _trials(rng)
    results = _fake_results(rng, trials, ("v5", "v1", "v2"))
    table = P.format_table(results)
    assert table == R.format_table(results)
    assert table.splitlines()[1].startswith("v1")


TINY = dataclasses.replace(
    P.CI_SCALE, num_train_speakers=4, num_eval_speakers=4, num_adapt_speakers=2,
    utts_per_speaker=4, eval_utts_per_speaker=5, enroll_utts=2, steps=6, am_steps=6,
    frame_dim=12, pool_dim=16, embed_dim=8, am_dim=12, am_bottleneck=6, batch_size=4,
    am_batch_size=16, ubm_gauss=8, ivector_dim=4,
    align=dataclasses.replace(P.CI_SCALE.align, num_leaves=16, mono_iters=2, refine_iters=1,
                              min_count=20.0))


def test_run_gauntlet_tiny_scale(tmp_path, capsys):
    results = P.run_gauntlet(str(tmp_path), TINY, variants=("v1", "v2", "v3", "v4", "v5"),
                             device="cpu")
    assert sorted(results) == ["v1", "v2", "v3", "v4", "v5"]
    for name, r in results.items():
        assert np.isfinite(r.pooled.eer) and 0.0 <= r.pooled.eer <= 1.0, name
        assert r.pooled.num_target > 0 and r.pooled.num_nontarget > 0
    out = capsys.readouterr().out
    assert out.count("[gauntlet_ali] running") == 1 and "[gauntlet:v5] EER" in out
    table = P.format_table(results)
    assert len(table.splitlines()) == 6
    # the s5 stage is content-keyed: a second call loads it
    data = P.make_gauntlet_data(TINY)
    ali = P.compute_alignments(data, TINY, str(tmp_path), device="cpu")
    assert "[gauntlet_ali] cached" in capsys.readouterr().out
    assert set(ali) <= set(data.train.audio) and all(a.dtype == np.int32 for a in ali.values())


def test_gauntlet_needs_a_gpu_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: P.run_gauntlet(str(tmp_path), TINY, variants=("v2",)),
                 lambda: P.run_adaptation_ablation(str(tmp_path), TINY),
                 lambda: P.run_augmentation_ablation(str(tmp_path), TINY)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not any(tmp_path.iterdir())
