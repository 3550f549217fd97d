"""Two-covariance PLDA: EM training, LLR scoring, unsupervised adaptation.

Replaces `ivector-compute-plda` (EM), `ivector-plda-scoring`
(log-likelihood-ratio scoring with by-the-book multi-enroll handling via
--num-utts, `egs/sre/v2/run_sre10.sh:239-246`) and `ivector-adapt-plda`
(covariance interpolation toward in-domain data,
`v2/run_sre16.sh:96-103`, scales 0.75/0.25).

Model: x = mu + y + e,  y ~ N(0, Phi_b) speaker factor, e ~ N(0, Phi_w).
After training, the model is stored *diagonalized*: a transform T with
T Phi_w T' = I and T Phi_b T' = diag(psi) — Kaldi's internal form — so
scoring is elementwise per dimension and the full trial matrix becomes
one batched computation:

  LLR(enroll u with n utts, test v) =
    sum_d [ logN(v_d ; n psi_d/(n psi_d+1) u_d , 1 + psi_d/(n psi_d+1))
          - logN(v_d ; 0, 1 + psi_d) ]

A numpy copy of `sepi_tpu/backend/plda.py`: the float64 host scoring
that is the reference's default (`BackendConfig.device_scoring=False`).
``score_trials(device=True)`` scores on a torch device instead
(`backend.device.plda_score_matrix_device`, float32).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

_LOG_2PI = float(np.log(2.0 * np.pi))


@dataclasses.dataclass
class Plda:
    mean: np.ndarray  # (D,)
    transform: np.ndarray  # (D, D): diagonalizing transform T
    psi: np.ndarray  # (D,) between-class variance in transformed space

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def preprocess(self, vectors: np.ndarray) -> np.ndarray:
        """Center + project into the diagonalized space.

        Mirrors Kaldi's TransformIvector (without its optional
        simple-length-norm): scoring inputs must already be
        length-normalized like the recipes do."""
        v = np.asarray(vectors, np.float64)
        return (v - self.mean) @ self.transform.T


def _speaker_stats(vectors: np.ndarray, labels: Sequence):
    by: Mapping = defaultdict(list)
    for i, lab in enumerate(labels):
        by[lab].append(i)
    x = np.asarray(vectors, np.float64)
    counts = np.array([len(idx) for idx in by.values()])
    means = np.stack([x[idx].mean(axis=0) for idx in by.values()])
    d = x.shape[1]
    sw = np.zeros((d, d))
    for idx in by.values():
        dk = x[idx] - x[idx].mean(axis=0)
        sw += dk.T @ dk
    return means, counts, sw


def train_plda(
    vectors: np.ndarray,
    labels: Sequence,
    num_iters: int = 10,
) -> Plda:
    """EM for the two-covariance model on labeled vectors."""
    x = np.asarray(vectors, np.float64)
    n_total, d = x.shape
    mu = x.mean(axis=0)
    xc = x - mu
    means, counts, sw = _speaker_stats(xc, labels)
    k = len(counts)
    if k < 2:
        raise ValueError("PLDA needs >= 2 speakers")

    # init: between = covar of class means, within = pooled within scatter
    phi_b = np.cov(means.T, bias=True) + 1e-6 * np.eye(d)
    phi_w = sw / max(n_total - k, 1) + 1e-6 * np.eye(d)

    for _ in range(num_iters):
        inv_b = np.linalg.inv(phi_b)
        inv_w = np.linalg.inv(phi_w)
        # E-step per distinct count value (vectorized within groups)
        ey = np.zeros_like(means)
        sum_cov = np.zeros((d, d))
        sum_resid = np.zeros((d, d))
        for c in np.unique(counts):
            sel = counts == c
            lam = inv_b + c * inv_w
            cov = np.linalg.inv(lam)
            w = (means[sel] * c) @ inv_w @ cov  # posterior means (speakers,)
            ey[sel] = w
            nsel = int(sel.sum())
            sum_cov += nsel * cov
            diff = means[sel] - w
            sum_resid += c * (diff.T @ diff) + c * nsel * cov
        # M-step
        phi_b = (sum_cov + ey.T @ ey) / k
        phi_w = (sw + sum_resid) / n_total
        phi_b += 1e-10 * np.eye(d)
        phi_w += 1e-10 * np.eye(d)

    return _diagonalize(mu, phi_b, phi_w)


def _diagonalize(mu: np.ndarray, phi_b: np.ndarray, phi_w: np.ndarray) -> Plda:
    """Find T: T phi_w T' = I, T phi_b T' = diag(psi), psi descending."""
    d = mu.shape[0]
    wvals, wvecs = np.linalg.eigh(phi_w)
    floor = max(wvals.max() * 1e-10, 1e-12)
    w_inv_sqrt = wvecs @ np.diag(1.0 / np.sqrt(np.maximum(wvals, floor))) @ wvecs.T
    b_white = w_inv_sqrt @ phi_b @ w_inv_sqrt
    bvals, bvecs = np.linalg.eigh(b_white)
    order = np.argsort(bvals)[::-1]
    t = bvecs[:, order].T @ w_inv_sqrt
    psi = np.maximum(bvals[order], 0.0)
    return Plda(mean=mu, transform=t, psi=psi)


def plda_score_matrix(
    plda: Plda,
    enroll: np.ndarray,  # (M, D) enrollment vectors (speaker means), raw space
    test: np.ndarray,  # (N, D) test vectors, raw space
    num_utts: Optional[np.ndarray] = None,  # (M,) enrollment utterance counts
) -> np.ndarray:
    """Full (M, N) LLR matrix, vectorized.

    ``num_utts`` enables the by-the-book multi-enroll scoring
    (`ivector-plda-scoring --num-utts`): an enrollment that averages n
    utterances has posterior speaker variance psi/(n psi + 1).
    """
    u = plda.preprocess(enroll)  # (M, D)
    v = plda.preprocess(test)  # (N, D)
    psi = plda.psi  # (D,)
    n = np.ones(u.shape[0]) if num_utts is None else np.asarray(num_utts, np.float64)

    npsi = n[:, None] * psi[None, :]  # (M, D)
    mean_scale = npsi / (npsi + 1.0)  # (M, D) — E[y|enroll] = scale * u
    var_given = 1.0 + psi[None, :] / (npsi + 1.0)  # (M, D)
    var_without = 1.0 + psi  # (D,)

    c = mean_scale * u  # (M, D) conditional means
    # logN(v; c, var_g) summed over D:
    #   -0.5*sum[ log(2pi var_g) + (v-c)^2/var_g ]
    # expand (v-c)^2 = v^2 - 2vc + c^2 -> GEMMs over D.
    inv_g = 1.0 / var_given  # (M, D)
    log_det_g = np.sum(np.log(var_given), axis=1)  # (M,)
    quad = (
        (v**2) @ inv_g.T  # (N, M): sum_d v^2 * inv_g
        - 2.0 * v @ (c * inv_g).T
        + np.sum(c * c * inv_g, axis=1)[None, :]  # (1, M)
    ).T  # (M, N)
    log_given = -0.5 * (plda.dim * _LOG_2PI + log_det_g[:, None] + quad)

    log_det_n = np.sum(np.log(var_without))
    quad_n = np.sum((v**2) / var_without[None, :], axis=1)  # (N,)
    log_without = -0.5 * (plda.dim * _LOG_2PI + log_det_n + quad_n)  # (N,)

    return log_given - log_without[None, :]


def adapt_plda(
    plda: Plda,
    adapt_vectors: np.ndarray,
    within_covar_scale: float = 0.75,
    between_covar_scale: float = 0.25,
    mean_diff_scale: float = 1.0,
) -> Plda:
    """ivector-adapt-plda: unsupervised domain adaptation, mirroring
    Kaldi's ``PldaUnsupervisedAdaptor::UpdatePlda`` step by step.

    The algorithm (ivector/plda.cc):
      1. mean/covariance of the in-domain vectors in the PLDA's input
         space, PLUS ``mean_diff_scale`` times the outer product of the
         adapt-vs-model mean difference (a systematic domain mean shift
         is itself unmodeled variability to absorb; Kaldi default 1.0);
      2. replace the model mean with the adapt-set mean;
      3. project the covariance by ``transform_mod`` — the PLDA
         transform ROW-SCALED by 1/sqrt(1+psi), i.e. into the space
         where the model's TOTAL covariance is identity (within =
         diag(1/(1+psi)), between = diag(psi/(1+psi)));
      4. eigendecompose; along every direction with eigenvalue above
         1.0 (more total variance than the model expects), add the
         excess into within/between with the given scales;
      5. fold back and re-diagonalize.

    HISTORY: until round 5 this routine projected with the plain PLDA
    transform (within-whitened space, total = I + diag(psi)) and
    thresholded each eigendirection against its model variance, and it
    omitted the mean-difference term — a genuine divergence from
    PldaUnsupervisedAdaptor found by the VERDICT-r4-mandated line-by-
    line diff.  The two constructions pick DIFFERENT eigenbases (the
    within-whitened space stretches speaker directions by 1+psi, so
    mismatch directions mix with speaker directions), which is exactly
    the failure the r4 ablation observed: the covariance step discounted
    real speaker variance and hurt EER at small adapt-set sizes.
    docs/BENCHMARKS.md carries the before/after ablation.
    """
    x = np.asarray(adapt_vectors, np.float64)
    mean = x.mean(axis=0)
    centered = x - mean
    variance = (centered.T @ centered) / x.shape[0]
    mean_diff = mean - plda.mean
    variance = variance + mean_diff_scale * np.outer(mean_diff, mean_diff)

    # transform into the total-covariance-whitened space
    scale = 1.0 / np.sqrt(1.0 + plda.psi)
    transform_mod = plda.transform * scale[:, None]
    variance_proj = transform_mod @ variance @ transform_mod.T

    s, p_mat = np.linalg.eigh(variance_proj)
    within = np.diag(1.0 / (1.0 + plda.psi))
    between = np.diag(plda.psi / (1.0 + plda.psi))
    for s_i, p in zip(s, p_mat.T):
        if s_i > 1.0:
            excess = s_i - 1.0
            within = within + within_covar_scale * excess * np.outer(p, p)
            between = between + between_covar_scale * excess * np.outer(p, p)

    # fold back into the raw space and re-diagonalize
    tm_inv = np.linalg.inv(transform_mod)
    phi_w = tm_inv @ within @ tm_inv.T
    phi_b = tm_inv @ between @ tm_inv.T
    return _diagonalize(mean, phi_b, phi_w)


def score_trials(
    plda: Plda,
    enroll_vecs: Mapping[str, np.ndarray],
    test_vecs: Mapping[str, np.ndarray],
    trials: Sequence,
    num_utts: Optional[Mapping[str, int]] = None,
    device: bool = False,
    scoring_device="cuda",
) -> Dict[Tuple[str, str], float]:
    """Score a trial list via the dense matrix (models x tests), then join.

    ``device=True`` (the reference's switch) computes the matrix in
    float32 on ``scoring_device`` (default ``"cuda"``; with no usable GPU
    it raises unless the caller names ``"cpu"``); otherwise float64 on
    the host."""
    models = sorted({t.model for t in trials})
    tests = sorted({t.test for t in trials})
    e = np.stack([enroll_vecs[m] for m in models])
    v = np.stack([test_vecs[t] for t in tests])
    n = None
    if num_utts is not None:
        n = np.array([num_utts.get(m, 1) for m in models], np.float64)
    if device:
        from .device import plda_score_matrix_device

        s = plda_score_matrix_device(plda, e, v, n, device=scoring_device).cpu().numpy()
    else:
        s = plda_score_matrix(plda, e, v, n)
    mi = {m: i for i, m in enumerate(models)}
    ti = {t: i for i, t in enumerate(tests)}
    return {(t.model, t.test): float(s[mi[t.model], ti[t.test]]) for t in trials}
