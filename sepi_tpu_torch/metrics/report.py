"""Per-condition evaluation reports.

Replaces the reference's per-condition scoring loops: SRE10
pooled/male/female (`get_eer.m` driven from `v2/run_sre10.sh:252-334`)
and SRE16 pooled/Tagalog/Cantonese (`v2/run_sre16.sh:113-117`), which are
awk joins of the trial list against condition keys.  Here a condition is
any function Trial -> list of condition names; every trial contributes to
each condition it names plus 'pooled'.

A copy of `sepi_tpu/metrics/report.py`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..data.manifest import Trial, Utterance
from .det import EvalResult, evaluate_scores


def evaluate_conditions(
    scores: Mapping[Tuple[str, str], float],
    trials: Sequence[Trial],
    condition_fn: Optional[Callable[[Trial], Sequence[str]]] = None,
) -> Dict[str, EvalResult]:
    """Score each condition subset (always includes 'pooled')."""
    buckets: Dict[str, Tuple[List[float], List[float]]] = {}

    def add(cond: str, trial: Trial, s: float):
        tgt, non = buckets.setdefault(cond, ([], []))
        (tgt if trial.target else non).append(s)

    for t in trials:
        s = scores.get((t.model, t.test))
        if s is None:
            continue
        add("pooled", t, s)
        if condition_fn is not None:
            for cond in condition_fn(t):
                add(cond, t, s)
    out = {}
    for cond, (tgt, non) in buckets.items():
        if tgt and non:
            out[cond] = evaluate_scores(np.asarray(tgt), np.asarray(non))
    return out


def metadata_condition(
    test_utts: Mapping[str, Utterance], key: str
) -> Callable[[Trial], Sequence[str]]:
    """Condition by a test-utterance metadata key (gender, language...)."""

    def fn(trial: Trial) -> Sequence[str]:
        u = test_utts.get(trial.test)
        if u is None:
            return ()
        v = u.get_meta(key)
        return (f"{key}:{v}",) if v is not None else ()

    return fn


def format_report(results: Mapping[str, EvalResult]) -> str:
    """The get_eer.m result table: eer / dcf08 / dcf10 / dcf12 rows."""
    lines = [
        f"{'condition':<20} {'EER%':>7} {'minDCF08':>9} {'minDCF10':>9} {'DCF12':>7} {'#tgt':>7} {'#non':>8}"
    ]
    for cond in sorted(results, key=lambda c: (c != "pooled", c)):
        r = results[cond]
        lines.append(
            f"{cond:<20} {r.eer * 100:>7.2f} {r.min_dcf08:>9.3f} "
            f"{r.min_dcf10 * 1000:>9.1f} {r.dcf12:>7.3f} "
            f"{r.num_target:>7} {r.num_nontarget:>8}"
        )
    return "\n".join(lines)
