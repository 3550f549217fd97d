"""fMLLR / CMLLR speaker-adaptive feature transforms.

Port of `sepi_tpu/align/fmllr.py`: the speaker-adapted alignment pass of
`steps/align_fmllr.sh` (the tri4a/tri5a/tri6a_4k stages of
`egs/sre/s5/run.sh:108-202`).  Given a GMM acoustic model and a
first-pass alignment, each speaker gets an affine feature transform
W = [A b] maximizing the EM auxiliary objective

    Q(W) = beta log|det A| - 1/2 sum_i (w_i G_i w_i' - 2 w_i k_i')

with the diagonal-covariance sufficient statistics (Gales 1998, the
estimator Kaldi's `gmm-est-fmllr` implements):

    k_i = sum_{t,c} gamma_c(t) mu_{c,i}/sigma2_{c,i} xi_t
    G_i = sum_{t,c} gamma_c(t) 1/sigma2_{c,i}  xi_t xi_t'
    xi_t = [x_t, 1],   beta = total occupancy

solved by row-wise iteration with the cofactor update.  The per-frame
component posteriors (`_frame_coeffs`, within the aligned pdf's mixture)
run in fp32 on the model's device; the statistics and the row solver
((D+1)^2 per row) are float64 host numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .mono import MonoAligner


@dataclasses.dataclass
class FmllrStats:
    """Per-speaker sufficient statistics (accumulable by addition)."""

    g: np.ndarray  # (D, D+1, D+1)
    k: np.ndarray  # (D, D+1)
    beta: float

    def __add__(self, other: "FmllrStats") -> "FmllrStats":
        return FmllrStats(self.g + other.g, self.k + other.k, self.beta + other.beta)


def _frame_coeffs(means: torch.Tensor, variances: torch.Tensor, mix_w: torch.Tensor,
                  feats: torch.Tensor):
    """Per-frame (sum_c gamma_c mu_c/var_c, sum_c gamma_c/var_c).

    means/variances: (T, C, D), the aligned pdf's mixture per frame;
    mix_w: (T, C) log mixture weights; feats: (T, D)."""
    inv_v = 1.0 / variances
    ll = mix_w - 0.5 * (
        torch.log(variances).sum(-1)
        + ((feats[:, None, :] - means) ** 2 * inv_v).sum(-1)
    )
    gamma = torch.softmax(ll, dim=1)  # (T, C)
    coef_mu = torch.einsum("tc,tcd->td", gamma, means * inv_v)
    coef_iv = torch.einsum("tc,tcd->td", gamma, inv_v)
    return coef_mu, coef_iv


def accumulate_fmllr_stats(
    model: MonoAligner,
    feats: np.ndarray,
    alignment: np.ndarray,
) -> FmllrStats:
    """Stats for one utterance from its per-frame pdf alignment."""
    t, d = feats.shape
    if len(alignment) != t:
        raise ValueError(f"alignment length {len(alignment)} != frames {t}")
    dev = model.device
    ali = torch.as_tensor(np.asarray(alignment, np.int64), device=dev)
    coef_mu, coef_iv = _frame_coeffs(
        model.means[ali], model.vars[ali], model.mix_w[ali],
        torch.as_tensor(feats, dtype=torch.float32, device=dev),
    )
    xi = np.concatenate([feats, np.ones((t, 1), feats.dtype)], axis=1)  # (T, D+1)
    k = np.einsum("ti,ta->ia", coef_mu.cpu().numpy().astype(np.float64), xi)
    g = np.einsum("ti,ta,tb->iab", coef_iv.cpu().numpy().astype(np.float64), xi, xi)
    return FmllrStats(g, k, float(t))


def estimate_fmllr(stats: FmllrStats, num_iters: int = 20,
                   min_beta: float = 200.0) -> np.ndarray:
    """Row-wise cofactor iteration -> W (D, D+1); identity if starved
    (``min_beta``: speakers with too few frames stay untransformed)."""
    d = stats.k.shape[0]
    w = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    if stats.beta < max(min_beta, d * (d + 1) / 2.0):
        return w
    g_inv = np.stack([np.linalg.inv(stats.g[i] + 1e-6 * np.eye(d + 1))
                      for i in range(d)])
    for _ in range(num_iters):
        for i in range(d):
            a = w[:, :d]
            cof = np.linalg.det(a) * np.linalg.inv(a).T
            v = np.concatenate([cof[i], [0.0]])
            gv = g_inv[i] @ v
            gk = g_inv[i] @ stats.k[i]
            qa = float(v @ gv)
            qb = float(v @ gk)
            disc = qb * qb + 4.0 * qa * stats.beta
            best, best_aux = None, -np.inf
            for sign in (+1.0, -1.0):
                alpha = (-qb + sign * np.sqrt(max(disc, 0.0))) / (2.0 * qa)
                wi = alpha * gv + gk
                det_term = float(v @ wi)
                if abs(det_term) < 1e-12:
                    continue
                aux = (stats.beta * np.log(abs(det_term))
                       - 0.5 * wi @ stats.g[i] @ wi + wi @ stats.k[i])
                if aux > best_aux:
                    best, best_aux = wi, aux
            if best is not None:
                w[i] = best
    return w


def apply_fmllr(feats: np.ndarray, w: np.ndarray) -> np.ndarray:
    """x -> A x + b, rows batched as one GEMM."""
    d = feats.shape[1]
    return (feats @ w[:, :d].T + w[:, d]).astype(feats.dtype)


def fmllr_transforms(
    model: MonoAligner,
    features: Mapping[str, np.ndarray],
    alignments: Mapping[str, np.ndarray],
    utt2spk: Mapping[str, str],
    num_iters: int = 20,
    min_beta: float = 200.0,
) -> Dict[str, np.ndarray]:
    """Per-speaker transforms from per-utterance stats (spk-summed)."""
    per_spk: Dict[str, FmllrStats] = {}
    for utt, f in features.items():
        if utt not in alignments or utt not in utt2spk:
            continue
        s = accumulate_fmllr_stats(model, f, alignments[utt])
        spk = utt2spk[utt]
        per_spk[spk] = s if spk not in per_spk else per_spk[spk] + s
    return {
        spk: estimate_fmllr(st, num_iters, min_beta)
        for spk, st in per_spk.items()
    }


def apply_fmllr_corpus(
    features: Mapping[str, np.ndarray],
    transforms: Mapping[str, np.ndarray],
    utt2spk: Mapping[str, str],
) -> Dict[str, np.ndarray]:
    return {
        utt: apply_fmllr(f, transforms[utt2spk[utt]])
        if utt2spk.get(utt) in transforms else f
        for utt, f in features.items()
    }


def fmllr_loglike_gain(
    model: MonoAligner,
    feats: np.ndarray,
    alignment: np.ndarray,
    w: np.ndarray,
) -> float:
    """Per-frame auxiliary improvement of the transform (diagnostic;
    Kaldi logs the same 'fMLLR objf impr per frame')."""
    def avg_ll(x):
        ali = np.asarray(alignment, np.int64)
        e = model.log_emissions(x).cpu().numpy()
        return float(np.mean(e[np.arange(len(ali)), ali]))

    d = feats.shape[1]
    logdet = float(np.log(abs(np.linalg.det(w[:, :d]))))
    return (avg_ll(apply_fmllr(feats, w)) + logdet) - avg_ll(feats)
