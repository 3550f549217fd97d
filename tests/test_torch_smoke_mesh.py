"""chip_smoke.py's phase 13 (the device mesh) rehearsed on the CPU: the
same rank processes, checks and prints as on the card, with gloo in place
of NCCL for 13a, a narrow x-vector, small 13c sizes and a small corpus v2
for 13d (its EER held below 50%, the narrow stand-in for phase 9's
initial weights)."""

import torch

import chip_smoke
from sepi_tpu_torch.config import ChunkConfig, OptimizerConfig, TrainConfig
from sepi_tpu_torch.models import XVectorConfig
from sepi_tpu_torch.models.tdnn import TdnnSpec

torch.set_num_threads(2)

SPECS = (TdnnSpec(24, (-2, -1, 0, 1, 2)), TdnnSpec(24, (-2, 0, 2)), TdnnSpec(24, (-3, 0, 3)),
         TdnnSpec(24, (0,)), TdnnSpec(64, (0,)))


def test_phase_mesh_rehearsal(tmp_path):
    corpus = chip_smoke.corpus_v2(train=(6, 5), evaluation=(10, 6), adapt=(3, 2))
    drv = {"corpus": corpus, "eer": {"v2": 0.0}, "eer_initial": {"v2": 0.5}}
    out = chip_smoke.phase_mesh(
        None, drv, device="cpu",
        cfg=XVectorConfig(feat_dim=23, num_speakers=40, frame_specs=SPECS, embed_dim=32),
        v2_steps=60, small=True, workdir=str(tmp_path / "mesh"),
        train_cfg=TrainConfig(optimizer=OptimizerConfig(initial_lr=0.02, final_lr=0.005,
                                                        proportional_shrink=0.5),
                              batch_size=16, chunks=ChunkConfig(50, 100, 2),
                              checkpoint_every=30),
        configs={"model_cfg": XVectorConfig(feat_dim=23, num_speakers=6, frame_specs=SPECS,
                                            embed_dim=32)})
    assert out["readings"]["13a"] <= 1.0 and out["readings"]["13b"] <= 1.0
    assert out["readings"]["fault"] > 1.0
    assert out["eer"] < 0.5
    assert out["launches"] == 0  # on the CPU the wrapper runs the plain version
