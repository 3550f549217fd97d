"""chip_smoke.py's phase 14 (the parity slice) rehearsed on the CPU: the
same code path, checks and prints as on the card, with a narrow x-vector
for 14b and 3 timed forwards for 14c.  On the CPU the MFCC wrapper runs
its plain version, so 14a's presets count no launch."""

import torch

import chip_smoke
from sepi_tpu_torch.models import XVectorConfig
from sepi_tpu_torch.models.tdnn import TdnnSpec

torch.set_num_threads(2)

SPECS = (TdnnSpec(24, (-2, -1, 0, 1, 2)), TdnnSpec(24, (-2, 0, 2)), TdnnSpec(24, (-3, 0, 3)),
         TdnnSpec(24, (0,)), TdnnSpec(64, (0,)))


def test_phase_parity_rehearsal(tmp_path):
    out = chip_smoke.phase_parity(
        None, device="cpu", workdir=str(tmp_path / "parity"), timed=3,
        cfg=XVectorConfig(feat_dim=23, num_speakers=40, frame_specs=SPECS, embed_dim=32))
    assert out["launches"] == 0
    assert out["mfcc_err"] <= chip_smoke.TOL
    assert out["stepwise_err"] == 0.0  # the CPU against itself
    assert out["reading"] <= 1.0 and out["equal"]
    assert out["entry_gap"] == 0.0
