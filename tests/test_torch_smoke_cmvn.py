"""`chip_smoke.py` phase 19 (the sliding-CMVN kernel) rehearsed on the CPU at
small shapes, where `sliding_cmvn` is the plain version: every case is held
against the plain version and float64, nothing is timed, and a CMVN planted
to be 1e-3 off fails 19a."""

import os
import sys

import pytest
import torch

from sepi_tpu_torch.ops import cmvn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

CASES = (("verification", 1, 660, 23, 300, [643]), ("extraction", 3, 900, 23, 300, None),
         ("long16k", 2, 1500, 80, 1000, None))


def test_phase_cmvn_rehearsal(capsys):
    rec = chip_smoke.phase_cmvn(None, device="cpu", cases=CASES)
    text = capsys.readouterr().out
    assert "phase 19 sliding-CMVN kernel on cpu" in text
    assert text.count("not timed (CPU)") == len(CASES)
    assert rec["name"] == "sliding_cmvn" and rec["bound_by"] == "bytes"
    assert [c["case"] for c in rec["cases"]] == [c[0] for c in CASES]
    assert rec["max_abs_err"] == 0.0  # the CPU route is the plain version itself
    assert all(c["ms"] is None for c in rec["cases"])
    # 19b: the CPU frontend runs eagerly, where nothing launches the kernel
    assert rec["launches_verify_capture"] == rec["launches_verify_replay"] == 0


def test_phase_cmvn_catches_a_planted_fault(monkeypatch):
    def planted(feats, mask, cfg=cmvn.CmvnConfig()):
        return cmvn.sliding_cmvn_reference(feats, mask, cfg) + 1e-3 * mask[..., None]

    planted.launches = 0
    monkeypatch.setattr(cmvn, "sliding_cmvn", planted)
    with pytest.raises(AssertionError, match="further from float64 than the plain version"):
        chip_smoke.phase_cmvn(None, device="cpu", cases=CASES[:1])
