"""The port's phonetic chain on the CPU, and its entry points' refusals.

- make_phonetic_corpus -> prepare_features_phonetic -> run_s5 (a small
  AlignConfig) -> select_voiced_ali -> AM pretraining -> v3, v4, v5 ->
  extract_and_score -> backend_eval: each system's EER on its own corpus
  below tests/test_phonetic.py's bound (0.15);
- every phonetic trainer raises without a GPU unless asked for the CPU,
  refuses a device its mesh does not hold, and trains in bfloat16 when
  asked (float32 parameters).
"""

import pytest
import torch

from sepi_tpu_torch.config import (AlignConfig, ChunkConfig, ExtractConfig, OptimizerConfig,
                                   TrainConfig)
from sepi_tpu_torch.data import make_phonetic_corpus
from sepi_tpu_torch.models import compute_dtype
from sepi_tpu_torch.models import cvector as tcv
from sepi_tpu_torch.models.tdnn import TdnnSpec
from sepi_tpu_torch.recipes import (
    backend_eval,
    extract_and_score,
    prepare_features_phonetic,
    run_s5,
    select_voiced_ali,
    train_adapted_model,
    train_am_model,
    train_combined_model,
    train_multitask_model,
)
from torch_dist import cpu_world_mesh

torch.set_num_threads(2)

AM_SPECS = [(24, (-2, -1, 0, 1, 2)), (24, (-1, 0, 1)), (24, (-1, 0, 1)), (24, (-3, 0, 3)),
            (12, (-6, -3, 0))]
WIDTHS = dict(num_speakers=6, embed_dim=32, hidden_dim=24, pool_dim=48)
OPT = dict(initial_lr=0.02, final_lr=0.005, proportional_shrink=0.5)
CHUNKS = dict(min_chunk_len=50, max_chunk_len=100, num_buckets=2)


def _am_cfg(num_senones):
    return tcv.AmConfig(num_senones=num_senones,
                        specs=tuple(TdnnSpec(d, o) for d, o in AM_SPECS))


@pytest.fixture(scope="module")
def chain():
    corpus = make_phonetic_corpus(num_speakers=6, utts_per_speaker=5, words_per_utt=(4, 6),
                                  seed=21)
    pf = prepare_features_phonetic(corpus.audio, device="cpu")
    s5 = run_s5(pf.full, corpus.transcripts, corpus.lexicon,
                AlignConfig(num_leaves=40, mono_iters=2, refine_iters=1, min_count=30.0),
                device="cpu")
    return corpus, pf.nosil, select_voiced_ali(s5.alignments, pf.voiced), s5.num_senones


def test_phonetic_chain_reaches_the_eer_bound(chain):
    """s5 labels feed AM pretraining and the three c-vector systems; each
    scores its own corpus below 0.15 EER."""
    corpus, nosil, ali, ns = chain
    assert sorted(ali) == sorted(nosil)
    assert all(len(ali[u]) == nosil[u].shape[0] for u in ali)
    am_cfg = _am_cfg(ns)
    tc = TrainConfig(optimizer=OptimizerConfig(**OPT), chunks=ChunkConfig(**CHUNKS),
                     batch_size=24, am_batch_size=64)
    enroll = {s: us[:1] for s, us in corpus.dataset.spk2utt.items()}

    def eer(model, min_frames, kw=None):
        embs = extract_and_score(model, None, nosil,
                                 ExtractConfig(min_chunk_size=25, chunk_size=300, batch_size=16),
                                 min_frames=min_frames, model_kwargs=kw, device="cpu")
        return backend_eval(embs, corpus.dataset, corpus.trials, enroll)[0].eer

    am_model, am_state = train_am_model(nosil, ali, am_cfg, tc, num_steps=80, device="cpu")
    v3cfg = tcv.MultitaskConfig(num_senones=ns, **WIDTHS)
    v3, _ = train_multitask_model(nosil, ali, corpus.dataset, v3cfg, tc, 160, device="cpu")
    v4cfg = tcv.AdaptedConfig(am=am_cfg, **WIDTHS)
    v4, _ = train_adapted_model(nosil, corpus.dataset, am_model, am_state, v4cfg, tc, 160,
                                device="cpu")
    v5cfg = tcv.CombinedConfig(num_senones=ns, am=am_cfg, **WIDTHS)
    v5, _ = train_combined_model(nosil, ali, corpus.dataset, am_model, am_state, v5cfg, tc, 160,
                                 device="cpu")
    eers = {"v3": eer(v3, sum(v3cfg.xvec_context) + 1, {"task": "xvec"}),
            "v4": eer(v4, sum(v4cfg.context) + 1),
            "v5": eer(v5, sum(v5cfg.xvec_context) + 1, {"task": "xvec"})}
    assert all(e < 0.15 for e in eers.values()), eers


def test_phonetic_entry_points_refuse_cpu_fallback(chain, monkeypatch):
    tc, feats, ali, ns = chain
    am = _am_cfg(ns)
    am_model = tcv.AmNet(am)
    calls = {
        "am": lambda **kw: train_am_model(feats, ali, am, num_steps=1, **kw),
        "multitask": lambda **kw: train_multitask_model(
            feats, ali, tc.dataset, tcv.MultitaskConfig(**WIDTHS), num_steps=1, **kw),
        "adapted": lambda **kw: train_adapted_model(
            feats, tc.dataset, am_model, None, tcv.AdaptedConfig(am=am, **WIDTHS), num_steps=1,
            **kw),
        "combined": lambda **kw: train_combined_model(
            feats, ali, tc.dataset, am_model, None, tcv.CombinedConfig(am=am, **WIDTHS),
            num_steps=1, **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bf16 = TrainConfig(chunks=ChunkConfig(**CHUNKS), batch_size=8, am_batch_size=16,
                       compute_dtype="bfloat16")
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
        with cpu_world_mesh() as mesh, pytest.raises(ValueError, match="mesh"):
            call(mesh=mesh, device="cuda")
        model, _ = call(train_cfg=bf16, device="cpu")
        assert compute_dtype(model) == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        TrainConfig(compute_dtype="float16")
