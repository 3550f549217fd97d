"""chip_smoke.py's phase 11 (bf16 compute and the on-device backend)
rehearsed on the CPU at narrow widths: phase 9 at the small size of
tests/test_torch_smoke_drivers.py, then 11b (CPU against CPU here), 11c
(run_v2, and run_v3 from phase 9's s5 stage, in bf16 on phase 9's corpus,
each EER below its initial weights')
and 11d (the device backend on ``device="cpu"`` at small shapes).  11a
times steps with CUDA events and runs on the card only."""

import numpy as np
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
V2 = dict(model_cfg=XVectorConfig(feat_dim=23, num_speakers=6, frame_specs=SPECS, embed_dim=32))
TRAIN = TrainConfig(optimizer=OptimizerConfig(initial_lr=0.02, final_lr=0.005,
                                              proportional_shrink=0.5),
                    batch_size=16, am_batch_size=64, chunks=ChunkConfig(50, 100, 2),
                    checkpoint_every=50)


def test_phase_bf16_rehearsal(tmp_path):
    # own work directories: tests/test_torch_smoke_drivers.py runs phase 9's
    # default one in another worker at the same time
    drv = chip_smoke.phase_driver_path(
        None, device="cpu", workdir=str(tmp_path / "drivers"), train=(6, 5), evaluation=(10, 6),
        adapt=(3, 2), v2_steps=100, num_steps=60, am_steps=40, train_cfg=TRAIN,
        configs={"v2": V2,
                 "v3": dict(model_cfg=MultitaskConfig(num_senones=64, **WIDTHS)),
                 "v4": dict(am_cfg=AM, model_cfg=AdaptedConfig(am=AM, **WIDTHS)),
                 "v5": dict(am_cfg=AM, model_cfg=CombinedConfig(num_senones=64, am=AM,
                                                                **WIDTHS))},
        align_cfg=AlignConfig(num_leaves=40, mono_iters=3, refine_iters=2, min_count=30.0),
        keep_s5=True)
    errs = chip_smoke.phase_bf16_agreement(None, device="cpu", batch=4,
                                           model_cfg=V2["model_cfg"])
    assert errs["embedding_a"] == errs["logits"] == errs["parameters"] == 0.0
    bf16 = chip_smoke.phase_bf16_driver(None, drv, device="cpu", v2_steps=100,
                                        train_cfg=TRAIN, configs=V2,
                                        workdir=str(tmp_path / "bf16"))
    assert bf16["eer"] < drv["eer_initial"]["v2"]
    assert bf16["eer_v3"] < drv["eer_initial"]["v3"]
    assert not (tmp_path / "drivers_s5").exists()
    assert bf16["mfcc_err"] == 0.0  # on the CPU the wrapper runs the plain version
    out = chip_smoke.phase_device_backend(None, drv, device="cpu", dims=(24, 64, 48),
                                          stream=(3000, 500))
    assert out["plda_err"] <= chip_smoke.PLDA_RTOL
    assert np.isfinite(out["eer_dev"]) and abs(out["eer_dev"] - out["eer_host"]) < 0.05
