from .det import EvalResult, eer, evaluate_scores, min_dcf, split_scores_by_trials

__all__ = ["EvalResult", "eer", "evaluate_scores", "min_dcf", "split_scores_by_trials"]
