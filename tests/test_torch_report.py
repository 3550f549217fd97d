"""The port's per-condition report and DET export against the JAX
package's: the same results and report strings, and the DET text and SVG
files byte for byte."""

import numpy as np
import pytest
import torch

from sepi_tpu.data.manifest import Trial as RefTrial
from sepi_tpu.data.manifest import Utterance as RefUtterance
from sepi_tpu.metrics import det as ref_det
from sepi_tpu.metrics import report as ref_report
from sepi_tpu_torch.data.manifest import Trial, Utterance
from sepi_tpu_torch.metrics import det, report

torch.set_num_threads(2)


def _trials(seed=0, n_spk=8, n_test=30):
    rng = np.random.default_rng(seed)
    rows, scores, meta = [], {}, {}
    for t in range(n_test):
        test = f"t{t:03d}"
        owner = int(rng.integers(n_spk))
        meta[test] = (("lang", ["tgl", "yue", "eng"][t % 3]),) if t % 5 else ()
        for m in range(n_spk):
            rows.append((f"m{m}", test, m == owner))
            if rng.random() < 0.97:  # some trials have no score
                scores[(f"m{m}", test)] = float(rng.normal(2.0 if m == owner else -1.0))
    return rows, scores, meta


@pytest.mark.parametrize("seed", [0, 1])
def test_conditions_and_report_equal_the_reference(seed):
    rows, scores, meta = _trials(seed)
    trials = [Trial(*r) for r in rows]
    ref_trials = [RefTrial(*r) for r in rows]
    utts = {u: Utterance(u, "s", meta=m) for u, m in meta.items()}
    ref_utts = {u: RefUtterance(u, "s", meta=m) for u, m in meta.items()}
    got = report.evaluate_conditions(scores, trials, report.metadata_condition(utts, "lang"))
    ref = ref_report.evaluate_conditions(scores, ref_trials,
                                         ref_report.metadata_condition(ref_utts, "lang"))
    assert sorted(got) == sorted(ref) and "pooled" in got and "lang:tgl" in got
    for c in ref:
        assert got[c].as_dict() == ref[c].as_dict()
    assert report.format_report(got) == ref_report.format_report(ref)
    plain = report.evaluate_conditions(scores, trials)
    assert list(plain) == ["pooled"] and plain["pooled"] == got["pooled"]


@pytest.mark.parametrize("suffix,n", [(".txt", 400), (".svg", 400), (".txt", 3000),
                                      (".svg", 3000)])
def test_det_export_bytes_equal_the_reference(tmp_path, suffix, n):
    rng = np.random.default_rng(n)
    tgt, non = rng.normal(2.0, 1.0, n // 10), rng.normal(0.0, 1.0, n)
    curve, ref_curve = det.compute_det(tgt, non), ref_det.compute_det(tgt, non)
    ours, theirs = str(tmp_path / f"a{suffix}"), str(tmp_path / f"b{suffix}")
    det.export_det_curve(curve, ours)
    ref_det.export_det_curve(ref_curve, theirs)
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read() and len(data) > 500
    np.testing.assert_array_equal(det.ppndf(curve.p_miss), ref_det.ppndf(ref_curve.p_miss))
