"""The classical v1 stack: GMM-UBM and i-vector extractor EM."""

from .gmm import (
    DiagGmm,
    FullGmm,
    GmmStats,
    accumulate_stats,
    accumulate_stats_sharded,
    diag_to_full,
    full_gmm_from_posteriors,
    gselect_posteriors,
    train_diag_ubm,
    train_full_ubm,
)
from .ivector import (
    IvectorExtractor,
    IvectorStats,
    extract_ivectors,
    init_extractor,
    posterior_ivectors,
    stats_from_features,
    train_ivector_extractor,
)

__all__ = [
    "DiagGmm",
    "FullGmm",
    "GmmStats",
    "IvectorExtractor",
    "IvectorStats",
    "accumulate_stats",
    "accumulate_stats_sharded",
    "diag_to_full",
    "extract_ivectors",
    "full_gmm_from_posteriors",
    "gselect_posteriors",
    "init_extractor",
    "posterior_ivectors",
    "stats_from_features",
    "train_diag_ubm",
    "train_full_ubm",
    "train_ivector_extractor",
]
