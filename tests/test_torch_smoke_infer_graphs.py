"""`chip_smoke.py` phase 17 (the compiled serving path) rehearsed on the CPU.

The CUDA graph itself needs the card, so the rehearsal replaces the
capture by `test_infer_graphs._Strict` (a graph that replays by running
its function again, its capture held against host syncs and copies) and
runs the phase at narrow widths: every check of 17a-17d holds and the
planted stale replay differs; with the key blind to the model's storage
(the planted fault), the replays after `model.to()` read the replaced
weights and 17a fails.
"""

import dataclasses
import os
import sys

import pytest
import torch

from sepi_tpu_torch import graphs
from sepi_tpu_torch.config import ExtractConfig
from sepi_tpu_torch.recipes import pipeline
from test_torch_bench import SMALL
from test_torch_infer_graphs import XCFG, _Strict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

ECFG = ExtractConfig(min_chunk_size=25, chunk_size=200, batch_size=8)
SHAPES = dataclasses.replace(SMALL, plda_models=64, plda_tests=48)


def _phase(**kw):
    return chip_smoke.phase_serving(None, device="cpu", v2_cfg=XCFG, ecfg=ECFG, shapes=SHAPES,
                                    audio=chip_smoke._p17_audio(n_same=24, n_odd=3),
                                    frontend_batch=6, **kw)


def test_phase_serving_rehearsal(monkeypatch, capsys):
    monkeypatch.setattr(graphs, "BACKEND", _Strict())
    monkeypatch.setattr(pipeline, "_KEPT", {})
    out = _phase()
    text = capsys.readouterr().out
    assert "DIFFERS" not in text and "phase 17 serving graphs on cpu" in text
    assert not out["planted"].startswith("0 ")
    # 17a: 4 buckets fp32 + 4 bf16 + 4 after the move; 17b: the shapes of 4 chains;
    # 17c: 2 shapes x 2 dtypes; 17d: 2 programs
    assert out["counts"]["infer"]["captures"] >= 12 + 4 + 4 + 2
    assert out["counts"]["infer"]["replays"] > 0 and out["launches"] == 0


def test_phase_serving_catches_a_stale_replay(monkeypatch):
    """A key blind to the model's storage: after `model.to()` the extractor
    replays graphs bound to the old weights, and 17a fails."""
    monkeypatch.setattr(graphs, "BACKEND", _Strict())
    monkeypatch.setattr(pipeline, "_KEPT", {})
    key = graphs.CallGraphs.key

    def blind(self, args):
        sig, _ = key(self, args)
        return sig, ()

    monkeypatch.setattr(graphs.CallGraphs, "key", blind)
    with pytest.raises(AssertionError, match="17a moved"):
        _phase()
