"""Vector post-processing (ivector-subtract-global-mean,
ivector-normalize-length) — the scoring-pipeline preprocessing every run
script applies (`egs/sre/v2/run_sre10.sh:221-246`)."""

from __future__ import annotations

import numpy as np


def subtract_global_mean(vectors: np.ndarray, mean: np.ndarray = None):
    """Returns (centered, mean).  ``mean`` can be a precomputed training
    mean (mean.vec in the recipes) applied to eval sets."""
    v = np.asarray(vectors, dtype=np.float64)
    if mean is None:
        mean = v.mean(axis=0)
    return v - mean, mean


def length_normalize(vectors: np.ndarray, scale_to_sqrt_dim: bool = True) -> np.ndarray:
    """Kaldi ivector-normalize-length: x * sqrt(dim)/||x||."""
    v = np.asarray(vectors, dtype=np.float64)
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    norms = np.maximum(norms, 1e-12)
    target = np.sqrt(v.shape[-1]) if scale_to_sqrt_dim else 1.0
    return v * (target / norms)
