"""Linear score fusion (tools/det_score/score_fusion_linear.m).

A numpy copy of `sepi_tpu/backend/fusion.py` (host float64, as there).

The reference fuses system scores with fixed linear weights on matched
trial lists; we reproduce that plus an optional logistic-regression
weight fit (the standard way those weights are chosen)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def linear_fusion(
    score_lists: Sequence[np.ndarray],
    weights: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Weighted sum of aligned score arrays; uniform weights by default."""
    arrs = [np.asarray(s, np.float64) for s in score_lists]
    n = arrs[0].shape
    for a in arrs:
        if a.shape != n:
            raise ValueError("score lists must be aligned (same trials)")
    if weights is None:
        weights = [1.0 / len(arrs)] * len(arrs)
    if len(weights) != len(arrs):
        raise ValueError("one weight per system")
    out = np.zeros_like(arrs[0])
    for w, a in zip(weights, arrs):
        out += w * a
    return out


def fit_fusion_weights(
    target_scores: Sequence[np.ndarray],
    nontarget_scores: Sequence[np.ndarray],
    num_iters: int = 200,
    lr: float = 0.1,
) -> np.ndarray:
    """Logistic-regression fusion weights (with bias dropped): maximize
    target-vs-nontarget separation of the fused score."""
    t = np.stack([np.asarray(s, np.float64) for s in target_scores], axis=1)
    n = np.stack([np.asarray(s, np.float64) for s in nontarget_scores], axis=1)
    x = np.concatenate([t, n])
    y = np.concatenate([np.ones(len(t)), np.zeros(len(n))])
    # standardize per system for stable steps
    mu, sd = x.mean(0), x.std(0) + 1e-9
    xs = (x - mu) / sd
    w = np.ones(x.shape[1]) / x.shape[1]
    b = 0.0
    for _ in range(num_iters):
        p = 1.0 / (1.0 + np.exp(-(xs @ w + b)))
        g = xs.T @ (p - y) / len(y)
        gb = np.mean(p - y)
        w -= lr * g
        b -= lr * gb
    w = np.maximum(w / sd, 0.0)
    s = w.sum()
    return w / s if s > 0 else np.ones_like(w) / len(w)
