"""chip_smoke.py's phase 9 (the recipe drivers) rehearsed on the CPU at
narrow widths: the same corpora, drivers, stage cache, read-back and
quality checks as on the card, with every size and width parameter of
the phase set to a narrow value."""

import torch

import chip_smoke
from sepi_tpu_torch.config import AlignConfig, ChunkConfig, OptimizerConfig, TrainConfig
from sepi_tpu_torch.models import (AdaptedConfig, AmConfig, CombinedConfig, MultitaskConfig,
                                   XVectorConfig)
from sepi_tpu_torch.models.tdnn import TdnnSpec

torch.set_num_threads(2)

SPECS = (TdnnSpec(24, (-2, -1, 0, 1, 2)), TdnnSpec(24, (-2, 0, 2)), TdnnSpec(24, (-3, 0, 3)),
         TdnnSpec(24, (0,)), TdnnSpec(64, (0,)))
AM = AmConfig(feat_dim=23, num_senones=64,
              specs=(TdnnSpec(16, (-2, -1, 0, 1, 2)), TdnnSpec(16, (-1, 0, 1)),
                     TdnnSpec(16, (-1, 0, 1)), TdnnSpec(16, (-3, 0, 3)),
                     TdnnSpec(8, (-6, -3, 0))))
WIDTHS = dict(num_speakers=6, embed_dim=24, hidden_dim=16, pool_dim=32)


def test_phase_driver_path_rehearsal():
    out = chip_smoke.phase_driver_path(
        None, device="cpu", train=(6, 5), evaluation=(10, 6), adapt=(3, 2), v2_steps=100,
        num_steps=60, am_steps=40,
        train_cfg=TrainConfig(optimizer=OptimizerConfig(initial_lr=0.02, final_lr=0.005,
                                                        proportional_shrink=0.5),
                              batch_size=16, am_batch_size=64, chunks=ChunkConfig(50, 100, 2),
                              checkpoint_every=50),
        configs={"v2": dict(model_cfg=XVectorConfig(feat_dim=23, num_speakers=6,
                                                    frame_specs=SPECS, embed_dim=32)),
                 "v3": dict(model_cfg=MultitaskConfig(num_senones=64, **WIDTHS)),
                 "v4": dict(am_cfg=AM, model_cfg=AdaptedConfig(am=AM, **WIDTHS)),
                 "v5": dict(am_cfg=AM, model_cfg=CombinedConfig(num_senones=64, am=AM,
                                                                **WIDTHS))},
        align_cfg=AlignConfig(num_leaves=40, mono_iters=3, refine_iters=2, min_count=30.0))
    assert set(out["eer"]) == set(out["eer_initial"]) == {"v2", "v3", "v4", "v5"}
    assert out["eer"]["v2"] < out["eer_initial"]["v2"]
    assert out["mfcc_err"] == 0.0  # on the CPU the wrapper runs the plain version
    assert out["viterbi_shapes"] and all(skip == 4 for _, _, skip in out["viterbi_shapes"])
