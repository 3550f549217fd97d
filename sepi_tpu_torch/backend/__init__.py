from .device import (
    compute_lda_device,
    length_normalize_device,
    plda_score_matrix_device,
    plda_score_matrix_sharded,
    train_plda_device,
)
from .fusion import fit_fusion_weights, linear_fusion
from .lda import LdaTransform, compute_lda
from .normalize import s_norm, t_norm, z_norm
from .plda import Plda, adapt_plda, plda_score_matrix, score_trials, train_plda
from .vector import length_normalize, subtract_global_mean

__all__ = [
    "LdaTransform",
    "Plda",
    "adapt_plda",
    "compute_lda",
    "compute_lda_device",
    "fit_fusion_weights",
    "length_normalize",
    "length_normalize_device",
    "linear_fusion",
    "plda_score_matrix",
    "plda_score_matrix_device",
    "plda_score_matrix_sharded",
    "s_norm",
    "score_trials",
    "subtract_global_mean",
    "t_norm",
    "train_plda",
    "train_plda_device",
    "z_norm",
]
