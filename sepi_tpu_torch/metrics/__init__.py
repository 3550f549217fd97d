from .det import (
    SRE08_DCF,
    SRE10_DCF,
    DetCurve,
    EvalResult,
    compute_det,
    eer,
    evaluate_scores,
    export_det_curve,
    min_dcf,
    ppndf,
    split_scores_by_trials,
)
from .report import evaluate_conditions, format_report, metadata_condition

__all__ = [
    "DetCurve",
    "compute_det",
    "eer",
    "evaluate_conditions",
    "export_det_curve",
    "format_report",
    "metadata_condition",
    "ppndf",
    "min_dcf",
    "SRE08_DCF",
    "SRE10_DCF",
    "evaluate_scores",
    "EvalResult",
    "split_scores_by_trials",
]
