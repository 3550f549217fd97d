"""chip_smoke.py's phase 12 (the command line) rehearsed on the CPU: the
Kaldi data dirs, `cli.main` for v2 and v3 (s5 with fMLLR), the Kaldi
interop with its `python -m sepi_tpu_torch` process, the fixtures, and the
gauntlet through the command line, with every size and width set narrow
(the drivers' model configs through the phase's hook, the gauntlet at a
tiny scale in place of CI_SCALE, whose calibrated pins it does not hold)."""

import torch

import chip_smoke
from sepi_tpu_torch.config import AlignConfig, ChunkConfig, OptimizerConfig, TrainConfig
from sepi_tpu_torch.models import MultitaskConfig, XVectorConfig
from sepi_tpu_torch.models.tdnn import TdnnSpec
from sepi_tpu_torch.recipes import gauntlet
from test_torch_gauntlet import TINY

torch.set_num_threads(2)

SPECS = (TdnnSpec(24, (-2, -1, 0, 1, 2)), TdnnSpec(24, (-2, 0, 2)), TdnnSpec(24, (-3, 0, 3)),
         TdnnSpec(24, (0,)), TdnnSpec(64, (0,)))
TRAIN = TrainConfig(optimizer=OptimizerConfig(initial_lr=0.02, final_lr=0.005,
                                              proportional_shrink=0.5),
                    batch_size=16, am_batch_size=64, chunks=ChunkConfig(50, 100, 2),
                    checkpoint_every=50)


def test_phase_cli_rehearsal(monkeypatch):
    corpus = chip_smoke.corpus_v2(train=(6, 5), evaluation=(10, 6), adapt=(1, 1))
    monkeypatch.setattr(gauntlet, "CI_SCALE", TINY)
    out = chip_smoke.phase_cli(
        None, corpus, device="cpu", v2_steps=100, v3_steps=100, bootstrap=20, embed_utts=8,
        pins=False,
        configs={"run_v2": dict(model_cfg=XVectorConfig(feat_dim=23, num_speakers=6,
                                                        frame_specs=SPECS, embed_dim=32),
                                train_cfg=TRAIN),
                 "run_v3": dict(model_cfg=MultitaskConfig(num_senones=64, num_speakers=6,
                                                          embed_dim=24, hidden_dim=16,
                                                          pool_dim=32),
                                train_cfg=TRAIN,
                                align_cfg=AlignConfig(num_leaves=40, mono_iters=3,
                                                      refine_iters=2, min_count=30.0,
                                                      fmllr=True))})
    assert out["eer"]["v2"] < out["eer_initial"]["v2"]
    assert out["eer"]["v3"] < out["eer_initial"]["v3"]
    assert set(out["gauntlet"]) == {"v2", "v5"}
    assert out["interop"]["emb_err"] <= chip_smoke.INTEROP_TOL
    assert out["interop"]["evaluated"]  # the evaluated model is a checkpoint-tail average
    assert out["mfcc_err"] == 0.0  # on the CPU the wrapper runs the plain version
    assert out["viterbi_shapes"]
