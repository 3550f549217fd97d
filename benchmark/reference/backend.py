"""Plain reference of the verification back end, in float64 NumPy.

`backend_eval`'s scoring path for one trial (`egs/sre/v2/run_sre10.sh:221-246`):
the embedding centred by the scoring mean, projected by LDA, length
normalised to sqrt(dim) (`ivector-normalize-length`), then the PLDA
log-likelihood ratio of the two-covariance model in its diagonalised form
(`ivector-plda-scoring --num-utts`):

  LLR = sum_d logN(v_d; n psi_d / (n psi_d + 1) u_d, 1 + psi_d / (n psi_d + 1))
        - logN(v_d; 0, 1 + psi_d)

with u and v the enrolment and test vectors centred by the PLDA mean and
rotated by its transform, and n the enrolment's utterance count.
"""

from __future__ import annotations

import numpy as np


def project(vec, mean, projection) -> np.ndarray:
    p = (np.asarray(vec, np.float64) - mean) @ projection.T
    return p * (np.sqrt(p.shape[-1]) / max(np.linalg.norm(p), 1e-12))


def _log_normal(x, mu, var) -> np.ndarray:
    return -0.5 * (np.log(2.0 * np.pi * var) + (x - mu) ** 2 / var)


def llr(enroll, test, n: float, plda_mean, transform, psi) -> float:
    u = (np.asarray(enroll, np.float64) - plda_mean) @ transform.T
    v = (np.asarray(test, np.float64) - plda_mean) @ transform.T
    given = _log_normal(v, n * psi / (n * psi + 1.0) * u, 1.0 + psi / (n * psi + 1.0))
    without = _log_normal(v, 0.0, 1.0 + psi)
    return float(np.sum(given - without))
