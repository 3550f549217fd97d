from .lda import LdaTransform, compute_lda
from .plda import Plda, adapt_plda, plda_score_matrix, score_trials, train_plda
from .vector import length_normalize, subtract_global_mean

__all__ = [
    "LdaTransform",
    "Plda",
    "adapt_plda",
    "compute_lda",
    "length_normalize",
    "plda_score_matrix",
    "score_trials",
    "subtract_global_mean",
    "train_plda",
]
