"""Kaldi backend-artifact interop: PLDA, bare vector and matrix files.

A copy of the part of `sepi_tpu/utils/kaldi_models.py` the recipe drivers
write and read back: the reference's exp-dir layout of a scoring backend
(``mean.vec`` / ``transform.mat`` from ``ivector-mean`` /
``ivector-compute-lda``, and ``plda`` from ``ivector-compute-plda``,
`v2/run_sre10.sh:221-246`).  The wire format is the published Kaldi object
serialization protocol (io-funcs.h framing: ``\\0B`` magic,
space-terminated tokens, size-prefixed basic types; ``FV``/``DV``/``FM``/
``DM`` dense markers and ``FP``/``DP`` packed-triangular markers).

`Plda` is member-for-member Kaldi's (mean, diagonalizing transform,
between-class psi; plda.h), so both directions are exact.  The UBM and
i-vector extractor readers and writers are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..backend.plda import Plda
from .nnet3 import _Reader, _Writer

__all__ = [
    "KaldiModelError",
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


def _write_packed(w: _Writer, x: np.ndarray, double: bool) -> None:
    """Packed symmetric matrix (SpMatrix): 'FP'/'DP', int32 dim, then the
    lower triangle row-major (row i carries i+1 entries)."""
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
