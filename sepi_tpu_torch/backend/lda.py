"""LDA projection (ivector-compute-lda --total-covariance-factor=0.0).

The recipes train LDA on per-utterance embeddings with speaker labels and
project to 150 dims (200 for i-vectors) before PLDA
(`egs/sre/v2/run_sre10.sh:224-231`, `v1/run_sre10.sh:142`).

Kaldi semantics reproduced: scatter matrices about class means; the
within-class covariance (optionally blended with total covariance by
``total_covariance_factor``) is whitened to identity, and the transform
rows are the leading eigenvectors of the whitened between-class
covariance — i.e. the output space has within-covar I and diagonal
between-covar, sorted by discriminability.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass
class LdaTransform:
    projection: np.ndarray  # (lda_dim, D)
    mean: np.ndarray  # (D,) training-data mean, subtracted before projecting

    def __call__(self, vectors: np.ndarray) -> np.ndarray:
        return (np.asarray(vectors, np.float64) - self.mean) @ self.projection.T


def compute_lda(
    vectors: np.ndarray,
    labels: Sequence,
    lda_dim: int,
    total_covariance_factor: float = 0.0,
) -> LdaTransform:
    x = np.asarray(vectors, dtype=np.float64)
    n, d = x.shape
    if lda_dim > d:
        raise ValueError(f"lda_dim {lda_dim} > feature dim {d}")
    mean = x.mean(axis=0)
    xc = x - mean

    by_class: Mapping = defaultdict(list)
    for i, lab in enumerate(labels):
        by_class[lab].append(i)
    if len(by_class) <= lda_dim:
        raise ValueError(
            f"need > lda_dim={lda_dim} classes, got {len(by_class)}"
        )

    sw = np.zeros((d, d))
    sb = np.zeros((d, d))
    for idx in by_class.values():
        xk = xc[idx]
        mk = xk.mean(axis=0)
        dk = xk - mk
        sw += dk.T @ dk
        sb += len(idx) * np.outer(mk, mk)
    sw /= n
    sb /= n

    st = sw + sb
    w = (1.0 - total_covariance_factor) * sw + total_covariance_factor * st
    # regularize tiny eigenvalues for safe whitening
    evals, evecs = np.linalg.eigh(w)
    floor = max(evals.max() * 1e-10, 1e-12)
    inv_sqrt = evecs @ np.diag(1.0 / np.sqrt(np.maximum(evals, floor))) @ evecs.T
    b_white = inv_sqrt @ sb @ inv_sqrt
    bvals, bvecs = np.linalg.eigh(b_white)
    order = np.argsort(bvals)[::-1][:lda_dim]
    proj = (bvecs[:, order].T @ inv_sqrt)
    return LdaTransform(projection=proj, mean=mean)
