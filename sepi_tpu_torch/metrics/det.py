"""DET / EER / minDCF evaluation — the acceptance oracle of the framework.

Replaces the reference's MATLAB DETware v2.1 stack
(`tools/det_score/DETware_v2.1/Compute_DET.m`, `Min_DCF.m`, `Set_DCF.m`,
`get_eer.m`, `Get_DCF_Plot_DET.m`) and Kaldi's `compute-eer` binary with a
single vectorized ROC sweep in NumPy.  Definitions match the reference:

- ``Compute_DET.m``: P_miss / P_fa as functions of a threshold swept over
  the sorted pooled scores.
- ``Min_DCF.m:30-40``: ``DCF(t) = C_miss * P_miss(t) * P_tgt
  + C_fa * P_fa(t) * (1 - P_tgt)``, minimized over t.
- ``Get_DCF_Plot_DET.m:30-39``: minDCF08 uses (C_miss=10, C_fa=1,
  P_tgt=0.01); minDCF10 uses (1, 1, 0.001) and is conventionally reported
  x1000; DCF12 = mean of the two (line 27).
- ``get_eer.m:1-15`` / Kaldi ``compute-eer``: EER is the rate where
  P_miss crosses P_fa.

A copy of `sepi_tpu/metrics/det.py`.  This is deliberately plain NumPy:
trial counts are O(1e5-1e7), the sweep is a sort + cumsum, and it runs
host-side at the end of an experiment, so a device path would pay
dispatch for nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

# (C_miss, C_fa, P_target) parameterizations, per Get_DCF_Plot_DET.m.
SRE08_DCF: Tuple[float, float, float] = (10.0, 1.0, 0.01)
SRE10_DCF: Tuple[float, float, float] = (1.0, 1.0, 0.001)


@dataclasses.dataclass(frozen=True)
class DetCurve:
    """A swept DET curve: miss/false-alarm probabilities per threshold.

    ``thresholds`` are the distinct operating points (score values);
    ``p_miss[i]`` / ``p_fa[i]`` are the error rates when accepting scores
    ``>= thresholds[i]``.
    """

    thresholds: np.ndarray
    p_miss: np.ndarray
    p_fa: np.ndarray
    num_target: int
    num_nontarget: int

    def eer(self) -> float:
        """Equal error rate via linear interpolation of the crossing."""
        pm, pf = self.p_miss, self.p_fa
        # Sweep runs from accept-nothing (pm=1, pf=0) toward accept-all
        # (pm=0, pf=1); find where pm-pf crosses zero from above.
        d = pm - pf
        idx = int(np.argmax(d <= 0))
        if idx == 0:
            return float((pm[0] + pf[0]) / 2.0)
        # Interpolate between idx-1 (d>0) and idx (d<=0).
        d0, d1 = d[idx - 1], d[idx]
        if d1 == d0:
            w = 0.0
        else:
            w = -d0 / (d1 - d0)
        eer_m = pm[idx - 1] + w * (pm[idx] - pm[idx - 1])
        eer_f = pf[idx - 1] + w * (pf[idx] - pf[idx - 1])
        return float((eer_m + eer_f) / 2.0)

    def min_dcf(
        self, c_miss: float, c_fa: float, p_target: float, normalize: bool = True
    ) -> float:
        """Minimum detection cost (Min_DCF.m semantics).

        With ``normalize`` the cost is divided by the best trivial system
        ``min(C_miss*P_tgt, C_fa*(1-P_tgt))`` (the NIST-normalized DCF,
        which is what DETware reports).
        """
        dcf = c_miss * self.p_miss * p_target + c_fa * self.p_fa * (1.0 - p_target)
        out = float(np.min(dcf))
        if normalize:
            out /= min(c_miss * p_target, c_fa * (1.0 - p_target))
        return out


def compute_det(
    target_scores: np.ndarray, nontarget_scores: np.ndarray
) -> DetCurve:
    """Vectorized ROC sweep over pooled scores.

    Equivalent to DETware ``Compute_DET.m`` but O(N log N): sort the pooled
    scores descending, cumulative-count targets/nontargets accepted at each
    threshold.
    """
    tgt = np.asarray(target_scores, dtype=np.float64).ravel()
    non = np.asarray(nontarget_scores, dtype=np.float64).ravel()
    if tgt.size == 0 or non.size == 0:
        raise ValueError(
            f"need both target ({tgt.size}) and nontarget ({non.size}) scores"
        )
    scores = np.concatenate([tgt, non])
    labels = np.concatenate(
        [np.ones(tgt.size, dtype=np.int64), np.zeros(non.size, dtype=np.int64)]
    )
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    labels = labels[order]

    # After accepting the top-k scores: fa = nontargets among them,
    # misses = targets below them.
    cum_tgt = np.cumsum(labels)
    cum_non = np.cumsum(1 - labels)
    # Operating points: include "accept nothing" then each distinct score.
    p_miss = np.concatenate([[1.0], (tgt.size - cum_tgt) / tgt.size])
    p_fa = np.concatenate([[0.0], cum_non / non.size])
    thresholds = np.concatenate([[np.inf], scores])

    # Collapse ties: keep only the last operating point per distinct score.
    keep = np.concatenate([thresholds[:-1] != thresholds[1:], [True]])
    return DetCurve(
        thresholds=thresholds[keep],
        p_miss=p_miss[keep],
        p_fa=p_fa[keep],
        num_target=int(tgt.size),
        num_nontarget=int(non.size),
    )


def ppndf(p: np.ndarray) -> np.ndarray:
    """Probit transform (inverse standard-normal CDF) — `ppndf.m`.

    DET curves are straight lines for Gaussian score distributions in
    these coordinates; probabilities are clipped away from {0, 1} like
    DETware does so axis limits stay finite."""
    from scipy.special import ndtri

    eps = 1e-6
    return ndtri(np.clip(np.asarray(p, np.float64), eps, 1.0 - eps))


def export_det_curve(curve: DetCurve, path: str, max_points: int = 2000) -> None:
    """Write the DET curve in probit coordinates — the `Plot_DET.m`
    artifact equivalent: a text table `p_fa p_miss ppndf(p_fa)
    ppndf(p_miss)` (plottable by anything) and, with a .svg suffix, a
    standalone SVG rendering with the DETware axis ticks."""
    pm, pf = curve.p_miss, curve.p_fa
    if len(pm) > max_points:
        idx = np.unique(np.linspace(0, len(pm) - 1, max_points).astype(int))
        pm, pf = pm[idx], pf[idx]
    xm, xf = ppndf(pm), ppndf(pf)
    if path.endswith(".svg"):
        _write_det_svg(path, xf, xm)
        return
    with open(path, "w") as f:
        f.write("# p_fa p_miss ppndf(p_fa) ppndf(p_miss)\n")
        for a, b, c, d in zip(pf, pm, xf, xm):
            f.write(f"{a:.6g} {b:.6g} {c:.5f} {d:.5f}\n")


# DETware Set_DET_limits.m tick probabilities
_DET_TICKS = [0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.4]


def _write_det_svg(path: str, xf: np.ndarray, xm: np.ndarray) -> None:
    lo, hi = ppndf(np.array([0.0005]))[0], ppndf(np.array([0.5]))[0]
    w = h = 480.0

    def sx(v):
        return (np.clip(v, lo, hi) - lo) / (hi - lo) * (w - 80) + 60

    def sy(v):
        return h - 30 - (np.clip(v, lo, hi) - lo) / (hi - lo) * (h - 60)

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:.0f}" height="{h:.0f}">',
        f'<rect width="{w:.0f}" height="{h:.0f}" fill="white"/>',
    ]
    for p in _DET_TICKS:
        v = ppndf(np.array([p]))[0]
        parts.append(
            f'<line x1="{sx(v):.1f}" y1="{h-30:.1f}" x2="{sx(v):.1f}" y2="30" '
            'stroke="#ddd"/>'
            f'<text x="{sx(v):.1f}" y="{h-14:.1f}" font-size="9" '
            f'text-anchor="middle">{p*100:g}</text>'
            f'<line x1="60" y1="{sy(v):.1f}" x2="{w-20:.1f}" y2="{sy(v):.1f}" '
            'stroke="#ddd"/>'
            f'<text x="50" y="{sy(v)+3:.1f}" font-size="9" '
            f'text-anchor="end">{p*100:g}</text>'
        )
    pts = " ".join(f"{sx(a):.1f},{sy(b):.1f}" for a, b in zip(xf, xm))
    parts.append(
        f'<polyline points="{pts}" fill="none" stroke="#1f4e89" stroke-width="1.5"/>'
    )
    parts.append(
        f'<text x="{w/2:.0f}" y="{h-2:.0f}" font-size="11" text-anchor="middle">'
        "False Alarm probability (%)</text>"
        f'<text x="12" y="{h/2:.0f}" font-size="11" text-anchor="middle" '
        f'transform="rotate(-90 12 {h/2:.0f})">Miss probability (%)</text>'
        "</svg>"
    )
    with open(path, "w") as f:
        f.write("\n".join(parts))


def eer(target_scores: np.ndarray, nontarget_scores: np.ndarray) -> float:
    return compute_det(target_scores, nontarget_scores).eer()


def min_dcf(
    target_scores: np.ndarray,
    nontarget_scores: np.ndarray,
    c_miss: float,
    c_fa: float,
    p_target: float,
    normalize: bool = True,
) -> float:
    return compute_det(target_scores, nontarget_scores).min_dcf(
        c_miss, c_fa, p_target, normalize
    )


@dataclasses.dataclass(frozen=True)
class EvalResult:
    """The per-condition result row the reference's get_eer.m produces."""

    eer: float  # fraction, not percent
    min_dcf08: float
    min_dcf10: float  # raw; reference reports x1000
    dcf12: float
    num_target: int
    num_nontarget: int

    def as_dict(self) -> Dict[str, float]:
        return {
            "eer_pct": self.eer * 100.0,
            "min_dcf08": self.min_dcf08,
            "min_dcf10_x1000": self.min_dcf10 * 1000.0,
            "dcf12": self.dcf12,
            "num_target": self.num_target,
            "num_nontarget": self.num_nontarget,
        }


def evaluate_scores(
    target_scores: np.ndarray, nontarget_scores: np.ndarray
) -> EvalResult:
    """One call = one row of the reference's result table (get_eer.m)."""
    det = compute_det(target_scores, nontarget_scores)
    d08 = det.min_dcf(*SRE08_DCF)
    d10 = det.min_dcf(*SRE10_DCF)
    return EvalResult(
        eer=det.eer(),
        min_dcf08=d08,
        min_dcf10=d10,
        dcf12=(d08 + d10) / 2.0,
        num_target=det.num_target,
        num_nontarget=det.num_nontarget,
    )


def split_scores_by_trials(
    scores: Mapping[Tuple[str, str], float],
    trials: Sequence[Tuple[str, str, bool]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Join a {(model, test): score} map against a trial list.

    Mirrors the awk joins of trials+scores the run scripts do before
    compute-eer (`egs/sre/v2/run_sre10.sh:252-255`).
    """
    tgt, non = [], []
    missing = 0
    for model, test, is_target in trials:
        s = scores.get((model, test))
        if s is None:
            missing += 1
            continue
        (tgt if is_target else non).append(s)
    if missing:
        raise KeyError(f"{missing}/{len(trials)} trials missing from scores")
    return np.asarray(tgt, dtype=np.float64), np.asarray(non, dtype=np.float64)
