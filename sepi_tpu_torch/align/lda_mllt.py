"""LDA+MLLT feature-space transform for the aligner ladder.

The port's own copy of `sepi_tpu/align/lda_mllt.py` (the port imports
nothing of the JAX package).  The reference's alignment quality rides on
tri3b's LDA+MLLT stage (`steps/train_lda_mllt.sh`, est-lda + est-mllt;
`egs/sre/s5/run.sh:130-140`) before SAT: splice frames ±context, project
with a class-discriminant LDA whose output space has identity
within-class covariance, then iterate MLLT (Gales' semi-tied covariance /
STC) rounds so diagonal-covariance GMMs fit the transformed space.  This
module operates on in-memory feature dicts + senone alignments:

  splice_features    = splice-feats (edge-clamped ±context)
  estimate_lda       = est-lda (whitening LDA: W Sw W^T = I)
  estimate_mllt      = est-mllt (MlltAccs + the row-wise cofactor update)

run_s5 interleaves the MLLT rounds with re-alignment.  All estimation is
float64 host numpy: these are one-shot O(D^2 T) scatter accumulations at
aligner-training time, not a per-step training path (same placement
rationale as backend/lda.py).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def splice_features(feats: np.ndarray, context: int = 3) -> np.ndarray:
    """(T, D) -> (T, (2*context+1)*D), edges clamped (splice-feats)."""
    T = feats.shape[0]
    idx = np.arange(T)[:, None] + np.arange(-context, context + 1)[None, :]
    idx = np.clip(idx, 0, T - 1)
    return feats[idx].reshape(T, -1)


def _class_scatter(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    num_classes: int,
    context: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Per-senone first/second-order stats over spliced frames.
    Returns (class_sums (C, D), class_counts (C,), total scatter (D, D),
    total frames)."""
    d = None
    sums = counts = scatter = None
    for u, f in features.items():
        if u not in alignments:
            continue
        x = splice_features(np.asarray(f, np.float64), context)
        a = np.asarray(alignments[u], np.int64)
        if len(a) != len(x):
            raise ValueError(f"{u}: alignment/feature length mismatch "
                             f"({len(a)} vs {len(x)})")
        if d is None:
            d = x.shape[1]
            sums = np.zeros((num_classes, d))
            counts = np.zeros(num_classes)
            scatter = np.zeros((d, d))
        np.add.at(sums, a, x)
        np.add.at(counts, a, 1.0)
        scatter += x.T @ x
    if d is None:
        raise ValueError("no aligned utterances")
    return sums, counts, scatter, float(counts.sum())


def estimate_lda(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    num_classes: int,
    context: int = 3,
    dim: int = 40,
    ridge: float = 1e-4,
) -> np.ndarray:
    """est-lda: class-discriminant projection over spliced frames.

    Returns W of shape (dim, (2*context+1)*D) with the Kaldi
    normalization W Sw W^T = I (within-class covariance whitened), so
    diagonal-GMM emissions are well-conditioned in the output space.
    """
    sums, counts, scatter, n = _class_scatter(
        features, alignments, num_classes, context
    )
    nz = counts > 0
    mu_c = np.zeros_like(sums)
    mu_c[nz] = sums[nz] / counts[nz, None]
    mu = sums.sum(axis=0) / n
    total = scatter / n - np.outer(mu, mu)
    between = (counts[nz, None, None]
               * np.einsum("ci,cj->cij", mu_c[nz] - mu, mu_c[nz] - mu)
               ).sum(axis=0) / n
    within = total - between
    d = within.shape[0]
    within += ridge * np.trace(within) / d * np.eye(d)
    # whiten within: within = U diag(s) U^T  ->  P = diag(s^-1/2) U^T
    s, u_mat = np.linalg.eigh(within)
    s = np.maximum(s, 1e-12)
    p = (u_mat / np.sqrt(s)).T
    # diagonalize between in the whitened space; top-dim directions
    bw = p @ between @ p.T
    evals, evecs = np.linalg.eigh(bw)
    order = np.argsort(evals)[::-1][:dim]
    w = evecs[:, order].T @ p  # rows: W Sw W^T = I by construction
    return w


def _senone_gaussians(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    num_classes: int,
    var_floor: float = 1e-3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single diagonal Gaussian per senone: (means, vars, counts)."""
    d = next(iter(features.values())).shape[1]
    sums = np.zeros((num_classes, d))
    sqs = np.zeros((num_classes, d))
    counts = np.zeros(num_classes)
    for u, f in features.items():
        if u not in alignments:
            continue
        x = np.asarray(f, np.float64)
        a = np.asarray(alignments[u], np.int64)
        np.add.at(sums, a, x)
        np.add.at(sqs, a, x * x)
        np.add.at(counts, a, 1.0)
    nz = counts > 0
    means = np.zeros_like(sums)
    means[nz] = sums[nz] / counts[nz, None]
    var = np.full_like(sums, 1.0)
    var[nz] = sqs[nz] / counts[nz, None] - means[nz] ** 2
    var = np.maximum(var, var_floor)
    return means, var, counts


def estimate_mllt(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    num_classes: int,
    row_sweeps: int = 10,
) -> np.ndarray:
    """est-mllt: one MLLT/STC round (Gales 1999; Kaldi mllt.cc).

    Accumulates G_i = sum_j sum_t (1/sigma^2_{j,i}) (x_t - mu_j)(x_t -
    mu_j)^T over Viterbi-hard senone occupancies j, then maximizes
      beta log|det M| - 0.5 sum_i m_i G_i m_i^T
    by the closed-form row update m_i = c_i G_i^{-1} * sqrt(beta /
    (c_i G_i^{-1} c_i^T)), c_i the i-th row of the cofactor matrix,
    sweeping rows ``row_sweeps`` times.  Returns the square M (D, D).
    """
    means, var, counts = _senone_gaussians(features, alignments, num_classes)
    d = means.shape[1]
    g = np.zeros((d, d, d))  # g[i] = G_i
    beta = 0.0
    for u, f in features.items():
        if u not in alignments:
            continue
        x = np.asarray(f, np.float64)
        a = np.asarray(alignments[u], np.int64)
        c = x - means[a]  # (T, D)
        beta += len(x)
        iv = 1.0 / var[a]  # (T, D)
        for i in range(d):
            cw = c * iv[:, i : i + 1]
            g[i] += cw.T @ c
    m = np.eye(d)
    ginv = np.stack([np.linalg.inv(g[i]) for i in range(d)])
    for _ in range(row_sweeps):
        for i in range(d):
            # cofactor row i of M: det(M) * inv(M).T row i
            cof = np.linalg.det(m) * np.linalg.inv(m).T[i]
            cg = cof @ ginv[i]
            denom = float(cg @ cof)
            if denom <= 0:
                continue
            m[i] = cg * np.sqrt(beta / denom)
    return m


def apply_transform(
    features: Mapping[str, np.ndarray], w: np.ndarray, context: int
) -> Dict[str, np.ndarray]:
    """Corpus map: splice ±context then project with W (rows out)."""
    return {
        u: (splice_features(np.asarray(f, np.float64), context) @ w.T
            ).astype(np.float32)
        for u, f in features.items()
    }


def mllt_objf_improvement(
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    num_classes: int,
    m: np.ndarray,
) -> float:
    """Per-frame auxiliary-objective gain of transform M over identity
    (the est-mllt log line): beta log|det M| - 0.5 sum_i m_i G_i m_i^T
    evaluated against identity, normalized by beta."""
    means, var, counts = _senone_gaussians(features, alignments, num_classes)
    d = means.shape[1]
    beta = float(counts.sum())

    def objf(mat):
        total = beta * np.log(abs(np.linalg.det(mat)))
        for u, f in features.items():
            if u not in alignments:
                continue
            x = np.asarray(f, np.float64)
            a = np.asarray(alignments[u], np.int64)
            c = (x - means[a]) @ mat.T
            total -= 0.5 * float(np.sum(c * c / var[a]))
        return total

    # note: vars are per-current-space; objf(identity) is the baseline
    return (objf(m) - objf(np.eye(d))) / max(beta, 1.0)
