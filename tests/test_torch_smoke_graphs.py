"""`chip_smoke.py` phase 16 (the captured step) rehearsed on the CPU.

The CUDA graph itself needs the card, so the rehearsal replaces the
capture by `test_torch_graphs._Rerun` (a graph that replays by running its
function again) and runs the phase at narrow widths (`test_torch_bench`'s
``SMALL`` shapes) with few steps: every check of 16a-16d holds, the
planted stale replay differs, and a planted fault in the captured path is
caught.
"""

import dataclasses
import os
import sys

import pytest
import torch

from sepi_tpu_torch.train import graphs
from test_torch_bench import SMALL
from test_torch_graphs import _Rerun

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

SHAPES = dataclasses.replace(SMALL, superstep=3)


def test_phase_graphs_rehearsal(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(graphs, "BACKEND", _Rerun())
    out = chip_smoke.phase_graphs(None, device="cpu", v2_cfg=SMALL.xvector, shapes=SHAPES,
                                  steps=4, workdir=str(tmp_path / "p16"))
    text = capsys.readouterr().out
    assert "DIFFERS" not in text and "phase 16 graphs on cpu" in text
    assert out["reading_d"] <= chip_smoke.TRAJ_TOL
    assert out["stale"]["clone"] == out["stale"]["load_checkpoint"] == "equal"
    assert out["stale"]["replaced opt_state"] == "equal"
    assert not out["stale"]["planted stale replay"].startswith("0 ")
    # 16a: 3 V2 graphs, 2 for two chunk lengths, the pair's 2, the Trainer's 4 (single
    # and superstep at each length); 16b 1; 16c 4; 16d 1
    assert out["counts"]["captures"] == 17 and out["counts"]["replays"] > 0


def test_phase_graphs_catches_a_step_that_is_not_the_eager_one(monkeypatch, tmp_path):
    """A captured step that reads the next count's scalars (an off-by-one
    in the rows the host fills) must fail 16a."""
    monkeypatch.setattr(graphs, "BACKEND", _Rerun())
    load = graphs.CapturedStep._load

    def shifted(self, state, feats, labels, weights):
        load(self, state, feats, labels, weights)
        rows = self.tx.scalar_rows(state.opt_state["count"] + 1, len(self.scalars))
        self.scalars.copy_(torch.from_numpy(rows))

    monkeypatch.setattr(graphs.CapturedStep, "_load", shifted)
    with pytest.raises(AssertionError, match="16a"):
        chip_smoke.phase_graphs(None, device="cpu", v2_cfg=SMALL.xvector, shapes=SHAPES,
                                steps=4, workdir=str(tmp_path / "p16"))
