"""chip_smoke.py's phase 10 (the v1 systems) rehearsed on the CPU at
narrow widths: phase 9's corpus-v2 recipe at a small size, run_v1 with
its random-T baseline (10a), the DNN/i-vector chain (10b) and the
card-against-CPU checks (10c, CPU against CPU here), with every size
parameter of the phase set to a small value."""

import numpy as np
import torch

import chip_smoke
from sepi_tpu_torch.config import IvectorConfig, OptimizerConfig, TrainConfig, UbmConfig
from sepi_tpu_torch.models import Nnet2Config
from sepi_tpu_torch.models.tdnn import TdnnSpec

torch.set_num_threads(2)

NNET2 = Nnet2Config(num_senones=24, pnorm_output_dim=16, group_size=4,
                    specs=tuple(TdnnSpec(16, o) for o in ((-2, -1, 0, 1, 2), (-1, 2), (0,),
                                                          (-3, 3), (-7, 2))))


def test_phase_v1_rehearsal():
    corpus = chip_smoke.corpus_v2(train=(8, 4), evaluation=(6, 4), adapt=(3, 2))
    ubm_cfg = UbmConfig(num_gauss=32, num_iters_init=3, num_iters_full=3)
    iv_cfg = IvectorConfig(ivector_dim=20, num_iters=3)
    v1 = chip_smoke.phase_v1_path(None, corpus, device="cpu", ubm_cfg=ubm_cfg, iv_cfg=iv_cfg,
                                  lda_dim=5)
    assert v1["eer"] < v1["eer_random"]
    assert set(v1["mfcc"]) == {20} and v1["mfcc"][20][1] == 0.0  # the plain version on the CPU
    dnn = chip_smoke.phase_v1_dnn_path(
        None, corpus, device="cpu", nnet2_cfg=NNET2, num_steps=60,
        train_cfg=TrainConfig(optimizer=OptimizerConfig(initial_lr=0.02, final_lr=0.005,
                                                        momentum=0.0, proportional_shrink=0.0),
                              am_batch_size=64),
        ubm_cfg=ubm_cfg, iv_cfg=iv_cfg, lda_dim=5)
    assert set(dnn["mfcc"]) == {20, 40} and np.isfinite(dnn["eer"])
    chip_smoke.phase_v1_agreement(None, v1, dnn, device="cpu", frames=512, utts=4, small_k=8,
                                  small_m=4, frontend_utts=12)
