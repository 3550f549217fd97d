"""`chip_smoke.py` phase 18 (the MFA-Conformer's score kernel on the main
path) rehearsed on the CPU at narrow widths, where the score route is the
plain one: every score call of every block is held against the plain
version, one a block and query block; a score route planted to be off by
1e-5 in one probability fails 18a."""

import os
import sys

import pytest
import torch

from sepi_tpu_torch.config import ExtractConfig
from sepi_tpu_torch.models import MfaConformerConfig
from sepi_tpu_torch.models import conformer as C

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

CFG = MfaConformerConfig(feat_dim=40, d_model=32, num_blocks=2, num_heads=2, ff_dim=64,
                         conv_kernel=5, attention_bottleneck=16, embed_dim=24, num_speakers=10)
ECFG = ExtractConfig(min_chunk_size=25, chunk_size=200, batch_size=4,
                     embedding_node="embedding")
BUDGET = 600_000  # 64 query rows of 97 at 4 rows and 2 heads: two query blocks a layer


def _phase(monkeypatch):
    monkeypatch.setattr(C, "ATTENTION_BLOCK_BYTES", BUDGET)
    return chip_smoke.phase_conformer(None, device="cpu", cfg=CFG, rows=4, frames=200,
                                      ecfg=ECFG)


def test_phase_conformer_rehearsal(monkeypatch, capsys):
    out = _phase(monkeypatch)
    text = capsys.readouterr().out
    assert "phase 18 MFA-Conformer score kernel on cpu" in text
    assert "4 score calls" in text  # 2 blocks x 2 query blocks, one bucket
    rec = out["record"]
    assert rec["name"] == "relpos_softmax" and rec["max_abs_err"] == 0.0
    assert rec["shapes_main_path"] == [[4, 2, 33, 97], [4, 2, 64, 97]]
    assert rec["launches"] == rec["launches_replay"] == 0  # the CPU route launches nothing
    assert rec["ms"] is None and rec["cases"] == []
    assert out["gap"] <= chip_smoke.P18_EMBED_RTOL


def test_phase_conformer_catches_a_planted_score_fault(monkeypatch):
    plain = C.relpos_softmax

    def off(ac, bd, lengths, scale):
        out = plain(ac, bd, lengths, scale)
        out[0, 0, 0, 0] += 1e-5
        return out

    monkeypatch.setattr(C, "relpos_softmax", off)
    with pytest.raises(AssertionError, match="18a: score max abs err"):
        _phase(monkeypatch)
