"""Score normalization: z-norm / t-norm / (adaptive) s-norm.

A numpy copy of `sepi_tpu/backend/normalize.py` (host float64, as there).

The reference exposes score-normalization hooks only implicitly (its
SRE16 path handles domain shift via PLDA adaptation instead); these are
the standard cohort-based normalizations a production deployment expects
alongside that (SURVEY.md §7 stage 7 "score normalization hooks").

All inputs are plain score matrices, so this composes with
`plda_score_matrix` or any other scorer:

  scores:               (M, N)  enroll x test trial scores
  enroll_cohort_scores: (M, C)  each enrollment model vs the cohort
  test_cohort_scores:   (N, C)  each test utterance vs the cohort
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _moments(cohort: np.ndarray, top_k: Optional[int]) -> tuple:
    if top_k is not None and top_k < cohort.shape[1]:
        idx = np.argpartition(-cohort, top_k, axis=1)[:, :top_k]
        sel = np.take_along_axis(cohort, idx, axis=1)
    else:
        sel = cohort
    return sel.mean(axis=1), sel.std(axis=1) + 1e-12


def z_norm(scores: np.ndarray, enroll_cohort_scores: np.ndarray,
           top_k: Optional[int] = None) -> np.ndarray:
    """Normalize per enrollment model."""
    mu, sd = _moments(enroll_cohort_scores, top_k)
    return (scores - mu[:, None]) / sd[:, None]


def t_norm(scores: np.ndarray, test_cohort_scores: np.ndarray,
           top_k: Optional[int] = None) -> np.ndarray:
    """Normalize per test utterance."""
    mu, sd = _moments(test_cohort_scores, top_k)
    return (scores - mu[None, :]) / sd[None, :]


def s_norm(
    scores: np.ndarray,
    enroll_cohort_scores: np.ndarray,
    test_cohort_scores: np.ndarray,
    top_k: Optional[int] = None,
) -> np.ndarray:
    """Symmetric norm: mean of z- and t-norm.  ``top_k`` selects the
    most-similar cohort members per side (adaptive s-norm, "as-norm")."""
    return 0.5 * (
        z_norm(scores, enroll_cohort_scores, top_k)
        + t_norm(scores, test_cohort_scores, top_k)
    )
