"""Kaldi trained-artifact interop: UBMs, i-vector extractor, PLDA, bare
vector and matrix files.

Port of `sepi_tpu/utils/kaldi_models.py`: the v1 recipe's trained
artifacts (``final.dubm`` DiagGmm, ``final.ubm`` FullGmm, ``final.ie``
IvectorExtractor, `v1/run_sre10.sh:89-160`) and the exp-dir layout of a
scoring backend (``mean.vec`` / ``transform.mat`` from ``ivector-mean`` /
``ivector-compute-lda``, and ``plda`` from ``ivector-compute-plda``,
`v2/run_sre10.sh:221-246`).  The wire format is the published Kaldi object
serialization protocol (io-funcs.h framing: ``\\0B`` magic,
space-terminated tokens, size-prefixed basic types; ``FV``/``DV``/``FM``/
``DM`` dense markers and ``FP``/``DP`` packed-triangular markers).

Model mapping (each conversion exact up to storage precision):
- DiagGmm stores ``means_invvars`` (mu/var) and ``inv_vars``; the port's
  `classical.gmm.DiagGmm` stores (weights, means, vars); ``gconsts`` are
  recomputed on write.
- FullGmm stores ``means_invcovars`` (Sigma^-1 mu) and packed
  ``inv_covars``; the port stores (weights, means, covars).
- IvectorExtractor: Kaldi's ``x ~ N(M_k w, Sigma_k)`` with prior
  ``w ~ N(offset e1, I)`` maps to ``mu_k = offset M_k[:, 0]``, ``T_k =
  W_k M_k`` in whitened space; Kaldi's written i-vectors (offset
  subtracted) equal the port's posterior means.  Export writes ``M =
  T_raw`` with the fitted offset when the means are colinear with T's
  first column, else prepends a mean-carrying column (``ivector_dim +
  1``, flagged in the returned metadata).
- `Plda` is member-for-member Kaldi's (mean, diagonalizing transform,
  between-class psi; plda.h).
Readers return the port's models with float32 tensors on ``device``;
writers take them from any device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..backend.plda import Plda
from ..device import DeviceLike, resolve_device
from .nnet3 import Nnet3ParseError, _Reader, _Writer

__all__ = [
    "KaldiModelError",
    "sniff_kaldi_object",
    "read_diag_ubm",
    "write_diag_ubm",
    "read_full_ubm",
    "write_full_ubm",
    "read_ivector_extractor",
    "write_ivector_extractor",
    "IvectorExtractorMeta",
    "read_plda",
    "write_plda",
    "read_kaldi_vector_file",
    "write_kaldi_vector_file",
    "read_kaldi_matrix_file",
    "write_kaldi_matrix_file",
]


class KaldiModelError(ValueError):
    pass


_KIND_BY_TOKEN = {
    "<DiagGMM>": "diag_ubm",
    "<FullGMM>": "full_ubm",
    "<IvectorExtractor>": "ivector_extractor",
    "<Plda>": "plda",
    "<Nnet3>": "nnet3",
    "<Nnet>": "nnet2",
    "<TransitionModel>": "transition_model",
    "FM": "matrix",
    "DM": "matrix",
    "FV": "vector",
    "DV": "vector",
}


def sniff_kaldi_object(path: str) -> str:
    """Identify a Kaldi binary object file by its leading token: one of
    diag_ubm, full_ubm, ivector_extractor, plda, nnet3, nnet2,
    transition_model, matrix, vector."""
    with open(path, "rb") as f:
        head = f.read(64)
    if head[:2] != b"\x00B":
        raise KaldiModelError(
            f"{path}: no Kaldi binary magic — text-format objects are not "
            "supported (rewrite with the matching copy tool and "
            "--binary=true)")
    tok = _Reader(head[2:]).read_token()
    kind = _KIND_BY_TOKEN.get(tok)
    if kind is None:
        raise KaldiModelError(f"{path}: unrecognized object token {tok!r}")
    return kind


def _open_reader(path: str, expect: str) -> _Reader:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\x00B":
        raise KaldiModelError(
            f"{path}: no Kaldi binary magic — text-format objects are not "
            "supported")
    r = _Reader(data[2:])
    first = r.read_token()
    if first != expect:
        raise KaldiModelError(
            f"{path}: expected {expect}, got {first!r} "
            f"(kind {_KIND_BY_TOKEN.get(first, 'unknown')!r})")
    return r


def _save(path: str, w: _Writer) -> None:
    with open(path, "wb") as f:
        f.write(b"\x00B" + w.getvalue())


def _read_packed(r: _Reader) -> np.ndarray:
    """Packed symmetric matrix (SpMatrix): 'FP'/'DP', int32 dim, then the
    lower triangle row-major (row i carries i+1 entries)."""
    marker = r.read_token()
    if marker not in ("FP", "DP"):
        raise Nnet3ParseError(f"packed-matrix marker {marker!r} at {r.pos}")
    dim = r.read_int32()
    if dim < 0:
        raise Nnet3ParseError(f"negative packed dim {dim}")
    dt = np.float32 if marker == "FP" else np.float64
    n = dim * (dim + 1) // 2
    tri = np.frombuffer(r._take(n * dt().itemsize), dtype=dt).astype(np.float64)
    out = np.zeros((dim, dim), np.float64)
    il = np.tril_indices(dim)
    out[il] = tri
    return out + np.tril(out, -1).T


def _write_packed(w: _Writer, x: np.ndarray, double: bool) -> None:
    x = np.asarray(x, np.float64)
    if x.ndim != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"packed write needs a square matrix, got {x.shape}")
    w.token("DP" if double else "FP")
    w.int32(x.shape[0])
    il = np.tril_indices(x.shape[0])
    w.raw(x[il].astype(np.float64 if double else np.float32).tobytes())


def _write_dense(w: _Writer, x: np.ndarray, double: bool) -> None:
    x = np.asarray(x)
    w.token("DM" if double else "FM")
    w.int32(x.shape[0])
    w.int32(x.shape[1])
    w.raw(x.astype(np.float64 if double else np.float32).tobytes())


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _dev32(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


_LOG_2PI = float(np.log(2.0 * np.pi))


def read_diag_ubm(path: str, device: DeviceLike = "cuda"):
    """final.dubm -> classical.gmm.DiagGmm on ``device``."""
    from ..classical.gmm import DiagGmm

    dev = resolve_device(device)
    r = _open_reader(path, "<DiagGMM>")
    r.expect_token("<GCONSTS>")
    r.read_vector()  # recomputed by log_likes; kept only for the format
    r.expect_token("<WEIGHTS>")
    weights = r.read_vector().astype(np.float64)
    r.expect_token("<MEANS_INVVARS>")
    means_invvars = r.read_matrix().astype(np.float64)
    r.expect_token("<INV_VARS>")
    inv_vars = r.read_matrix().astype(np.float64)
    r.expect_token("</DiagGMM>")
    if (means_invvars.shape[0] != weights.shape[0]
            or inv_vars.shape != means_invvars.shape):
        raise KaldiModelError(
            f"{path}: inconsistent dims weights={weights.shape} "
            f"means_invvars={means_invvars.shape} inv_vars={inv_vars.shape}")
    if np.any(inv_vars <= 0):
        raise KaldiModelError(f"{path}: non-positive inverse variances")
    vars_ = 1.0 / inv_vars
    means = means_invvars * vars_
    return DiagGmm(_dev32(weights, dev), _dev32(means, dev), _dev32(vars_, dev))


def write_diag_ubm(path: str, gmm) -> None:
    """classical.gmm.DiagGmm -> final.dubm (BaseFloat=float storage)."""
    weights = _host64(gmm.weights)
    means = _host64(gmm.means)
    vars_ = _host64(gmm.vars)
    inv_vars = 1.0 / vars_
    gconsts = np.log(weights) - 0.5 * (
        means.shape[1] * _LOG_2PI
        + np.sum(np.log(vars_), axis=1)
        + np.sum(means * means * inv_vars, axis=1)
    )
    w = _Writer()
    w.token("<DiagGMM>")
    w.token("<GCONSTS>")
    w.vector(gconsts.astype(np.float32))
    w.token("<WEIGHTS>")
    w.vector(weights.astype(np.float32))
    w.token("<MEANS_INVVARS>")
    _write_dense(w, means * inv_vars, double=False)
    w.token("<INV_VARS>")
    _write_dense(w, inv_vars, double=False)
    w.token("</DiagGMM>")
    _save(path, w)


def read_full_ubm(path: str, device: DeviceLike = "cuda"):
    """final.ubm -> classical.gmm.FullGmm on ``device``."""
    from ..classical.gmm import FullGmm

    dev = resolve_device(device)
    r = _open_reader(path, "<FullGMM>")
    r.expect_token("<GCONSTS>")
    r.read_vector()
    r.expect_token("<WEIGHTS>")
    weights = r.read_vector().astype(np.float64)
    r.expect_token("<MEANS_INVCOVARS>")
    means_invcovars = r.read_matrix().astype(np.float64)
    r.expect_token("<INV_COVARS>")
    k = weights.shape[0]
    if means_invcovars.shape[0] != k:
        raise KaldiModelError(
            f"{path}: {k} weights but {means_invcovars.shape[0]} means_invcovars rows")
    covars = np.zeros((k, means_invcovars.shape[1], means_invcovars.shape[1]))
    means = np.zeros_like(means_invcovars)
    for i in range(k):
        inv_cov = _read_packed(r)
        cov = np.linalg.inv(inv_cov)
        covars[i] = 0.5 * (cov + cov.T)
        means[i] = covars[i] @ means_invcovars[i]
    r.expect_token("</FullGMM>")
    return FullGmm(_dev32(weights, dev), _dev32(means, dev), _dev32(covars, dev))


def write_full_ubm(path: str, gmm) -> None:
    """classical.gmm.FullGmm -> final.ubm."""
    weights = _host64(gmm.weights)
    means = _host64(gmm.means)
    covars = _host64(gmm.covars)
    k, d = means.shape
    inv_covars = np.zeros_like(covars)
    means_invcovars = np.zeros_like(means)
    gconsts = np.zeros(k)
    for i in range(k):
        inv_cov = np.linalg.inv(covars[i])
        inv_covars[i] = 0.5 * (inv_cov + inv_cov.T)
        means_invcovars[i] = inv_covars[i] @ means[i]
        sign, logdet = np.linalg.slogdet(inv_covars[i])
        if sign <= 0:
            raise KaldiModelError(f"component {i}: covariance not SPD")
        gconsts[i] = (
            np.log(weights[i])
            - 0.5 * d * _LOG_2PI
            + 0.5 * logdet
            - 0.5 * means[i] @ inv_covars[i] @ means[i]
        )
    w = _Writer()
    w.token("<FullGMM>")
    w.token("<GCONSTS>")
    w.vector(gconsts.astype(np.float32))
    w.token("<WEIGHTS>")
    w.vector(weights.astype(np.float32))
    w.token("<MEANS_INVCOVARS>")
    _write_dense(w, means_invcovars, double=False)
    w.token("<INV_COVARS>")
    for i in range(k):
        _write_packed(w, inv_covars[i], double=False)
    w.token("</FullGMM>")
    _save(path, w)


@dataclasses.dataclass
class IvectorExtractorMeta:
    """Fields of the Kaldi file that carry no information the extractor
    uses numerically, kept for faithful re-export: the latent prior
    offset, the i-vector-dependent weight projection ``w`` (present when
    the extractor was trained with --use-weights=true, the sid default),
    and the static weight vector ``w_vec``."""

    prior_offset: float
    w: np.ndarray  # (K, M) or (0, 0)
    w_vec: np.ndarray  # (K,) or (0,)
    mean_column_added: bool = False  # export-side: ivector dim grew by 1


def read_ivector_extractor(path: str, device: DeviceLike = "cuda"):
    """final.ie -> (classical.ivector.IvectorExtractor on ``device``,
    IvectorExtractorMeta).  Kaldi's written i-vectors equal
    `extract_ivectors` on the result exactly when the file has no
    i-vector-dependent weight projection; an extractor trained with
    ``--use-weights=true`` (nonempty ``<w>``) adds a second-order
    weight-likelihood term to Kaldi's posterior that this model does not
    reproduce, and such an import warns and keeps ``w`` in the metadata."""
    from ..classical.ivector import IvectorExtractor

    dev = resolve_device(device)
    r = _open_reader(path, "<IvectorExtractor>")
    r.expect_token("<w>")
    w_proj = r.read_matrix().astype(np.float64)
    r.expect_token("<w_vec>")
    w_vec = r.read_vector().astype(np.float64)
    r.expect_token("<M>")
    k = r.read_int32()
    if not (0 < k < 1_000_000):
        raise KaldiModelError(f"{path}: implausible component count {k}")
    m_list = [r.read_matrix().astype(np.float64) for _ in range(k)]
    d, _ = m_list[0].shape
    r.expect_token("<SigmaInv>")
    sigma_inv = np.stack([_read_packed(r) for _ in range(k)])
    r.expect_token("<IvectorOffset>")
    prior_offset = r.read_float()
    r.expect_token("</IvectorExtractor>")
    if w_proj.size:
        warnings.warn(
            f"{path}: extractor was trained with --use-weights=true "
            "(nonempty <w>); the weight-likelihood refinement term is "
            "not modeled — extracted i-vectors match ivector-extract up "
            "to that second-order term, not exactly",
            stacklevel=2)
    m_arr = np.stack(m_list)  # (K, D, M)
    covars = np.linalg.inv(sigma_inv)
    covars = 0.5 * (covars + covars.transpose(0, 2, 1))
    chol = np.linalg.cholesky(covars)
    eye = np.eye(d)
    whitener = np.stack([np.linalg.solve(chol[i], eye) for i in range(k)])
    t_white = np.einsum("kde,kem->kdm", whitener, m_arr)
    means = prior_offset * m_arr[:, :, 0]
    ext = IvectorExtractor(_dev32(t_white, dev), _dev32(whitener, dev), _dev32(means, dev))
    return ext, IvectorExtractorMeta(prior_offset, w_proj, w_vec)


def write_ivector_extractor(path: str, ext, meta: Optional[IvectorExtractorMeta] = None,
                            prior_offset: float = 100.0) -> IvectorExtractorMeta:
    """classical.ivector.IvectorExtractor -> final.ie.

    If the extractor's means are colinear with T's first raw-space column
    (always true for a model imported from Kaldi), the fitted scale is the
    prior offset and ``M = T_raw``: an exact round trip.  Otherwise a
    mean-carrying first column is prepended (``ivector_dim + 1``) and the
    returned metadata has ``mean_column_added=True``."""
    t_white = _host64(ext.t)  # (K, D, M)
    whitener = _host64(ext.whitener)  # (K, D, D)
    means = _host64(ext.means)  # (K, D)
    k, d, m_dim = t_white.shape
    # raw-space T and Sigma^-1 from the whitener: W = chol(Sigma)^-1, so
    # T_raw = W^-1 T_white and Sigma^-1 = W' W
    t_raw = np.stack([np.linalg.solve(whitener[i], t_white[i]) for i in range(k)])
    sigma_inv = np.einsum("ked,kem->kdm", whitener, whitener)
    sigma_inv = 0.5 * (sigma_inv + sigma_inv.transpose(0, 2, 1))

    col0 = t_raw[:, :, 0]
    den = float(np.sum(col0 * col0))
    alpha = float(np.sum(col0 * means)) / den if den > 0 else 0.0
    resid = float(np.linalg.norm(means - alpha * col0))
    exact = abs(alpha) > 1e-6 and resid <= 1e-4 * max(float(np.linalg.norm(means)), 1e-12)
    if exact:
        offset, m_out, added = alpha, t_raw, False
    else:
        offset, added = float(prior_offset), True
        m_out = np.concatenate([means[:, :, None] / offset, t_raw], axis=2)
        warnings.warn(
            f"{path}: natively-trained extractor (means not colinear with "
            f"T's first column) — exported with a mean-carrying extra "
            f"column, ivector dim {m_dim} -> {m_dim + 1}; Kaldi-side "
            "ivector-extract pins the extra coordinate only approximately "
            "at the prior offset, so extracted i-vectors match natively "
            "extracted ones approximately, not exactly",
            stacklevel=2)

    if meta is not None and meta.w.size and meta.w.shape[1] == m_out.shape[2]:
        w_proj = meta.w
    else:
        w_proj = np.zeros((0, 0))
    if meta is not None and meta.w_vec.size == k:
        w_vec = meta.w_vec
    else:
        w_vec = np.full(k, 1.0 / k)

    w = _Writer()
    w.token("<IvectorExtractor>")
    w.token("<w>")
    _write_dense(w, w_proj, double=True)
    w.token("<w_vec>")
    w.vector(np.asarray(w_vec, np.float64), double=True)
    w.token("<M>")
    w.int32(k)
    for i in range(k):
        _write_dense(w, m_out[i], double=True)
    w.token("<SigmaInv>")
    for i in range(k):
        _write_packed(w, sigma_inv[i], double=True)
    w.token("<IvectorOffset>")
    w.float64(offset)
    w.token("</IvectorExtractor>")
    _save(path, w)
    return IvectorExtractorMeta(offset, w_proj, np.asarray(w_vec, np.float64),
                                mean_column_added=added)


def read_plda(path: str) -> Plda:
    """plda file -> backend.plda.Plda (exact: members are 1:1)."""
    r = _open_reader(path, "<Plda>")
    mean = r.read_vector().astype(np.float64)
    transform = r.read_matrix().astype(np.float64)
    psi = r.read_vector().astype(np.float64)
    r.expect_token("</Plda>")
    if transform.shape != (mean.shape[0], mean.shape[0]) or psi.shape != mean.shape:
        raise KaldiModelError(
            f"{path}: inconsistent Plda dims mean={mean.shape} "
            f"transform={transform.shape} psi={psi.shape}")
    return Plda(mean, transform, psi)


def write_plda(path: str, plda) -> None:
    """backend.plda.Plda -> Kaldi plda file (double storage, like Kaldi)."""
    w = _Writer()
    w.token("<Plda>")
    w.vector(np.asarray(plda.mean, np.float64), double=True)
    _write_dense(w, np.asarray(plda.transform, np.float64), double=True)
    w.vector(np.asarray(plda.psi, np.float64), double=True)
    w.token("</Plda>")
    _save(path, w)


def read_kaldi_vector_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\x00B":
        raise KaldiModelError(f"{path}: no Kaldi binary magic")
    return _Reader(data[2:]).read_vector().astype(np.float64)


def write_kaldi_vector_file(path: str, x: np.ndarray, double: bool = False) -> None:
    w = _Writer()
    w.vector(np.asarray(x), double=double)
    _save(path, w)


def read_kaldi_matrix_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\x00B":
        raise KaldiModelError(f"{path}: no Kaldi binary magic")
    return _Reader(data[2:]).read_matrix().astype(np.float64)


def write_kaldi_matrix_file(path: str, x: np.ndarray, double: bool = False) -> None:
    w = _Writer()
    _write_dense(w, np.asarray(x), double=double)
    _save(path, w)
