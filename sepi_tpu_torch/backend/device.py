"""The backend's heavy stages on the card, in float32.

Port of `sepi_tpu/backend/device.py`.  The numpy backend (`lda.py`,
`plda.py`, `vector.py`) is the float64 reference semantics; these
functions move its O(N D^2) and O(M N D) stages onto a torch device:

- ``plda_score_matrix_device``: the (models x tests) LLR trial matrix as
  two GEMMs and elementwise terms (the `ivector-plda-scoring` hot loop,
  `egs/sre/v2/run_sre10.sh:239-246`);
- ``scatter_stats_device``: per-class sums and the within-class scatter,
  shared by LDA (`ivector-compute-lda`) and the PLDA EM's initialisation;
- ``train_plda_device``: the two-covariance EM with the per-speaker
  posterior solves batched on the device, blocked over speakers;
- ``compute_lda_device`` and ``length_normalize_device``.

Each takes ``device=`` (default ``"cuda"``; the CPU only when named) and
runs inside `device.fp32_math`: the LLR is the expansion
``v^2 inv_g - 2 v c inv_g + const`` and the scatter ``X'X - sum_k n_k m_k
m_k'``, both of which cancel, and TF32 products (10-bit mantissas) would
not stay within 1e-3 of the float64 path.  The per-class sums are a
one-hot GEMM in row blocks, not atomics, so they are the same from run to
run.  The small (D, D) eigendecompositions stay on the host in float64,
as in the reference.  ``plda_score_matrix_sharded`` splits the models
over a device mesh: each rank scores its block of enrollment rows with
the single-card body, and the blocks are gathered.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, fp32_math, resolve_device
from .lda import LdaTransform
from .plda import Plda, _diagonalize

_LOG_2PI = float(np.log(2.0 * np.pi))
# rows of the one-hot GEMM per block: bounds its (rows x classes) operand
_SEGMENT_ROWS = 8192


def _f32(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


@fp32_math()
def length_normalize_device(vectors, scale_to_sqrt_dim: bool = True,
                            device: DeviceLike = "cuda") -> torch.Tensor:
    """Kaldi ivector-normalize-length: x * sqrt(dim) / ||x||."""
    v = _f32(vectors, resolve_device(device))
    norms = torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    target = math.sqrt(v.shape[-1]) if scale_to_sqrt_dim else 1.0
    return v * (target / norms)


def _llr_terms(psi: torch.Tensor, u: torch.Tensor, n: torch.Tensor):
    """Per-model terms of the diagonalised-space LLR (see plda.py)."""
    npsi = n[:, None] * psi[None, :]  # (M, D)
    mean_scale = npsi / (npsi + 1.0)
    var_given = 1.0 + psi[None, :] / (npsi + 1.0)  # (M, D)
    c = mean_scale * u  # conditional means (M, D)
    inv_g = 1.0 / var_given
    log_det_g = torch.sum(torch.log(var_given), dim=1)  # (M,)
    const_m = torch.sum(c * c * inv_g, dim=1)  # (M,)
    return c, inv_g, log_det_g, const_m


def _llr_block(psi, u, n, v2, v, d: int) -> torch.Tensor:
    """(M, N) log N(v; c_m, var_given_m) given the test side's v and v^2."""
    c, inv_g, log_det_g, const_m = _llr_terms(psi, u, n)
    # quad[m, t] = sum_d v_td^2 inv_g_md - 2 v_td c_md inv_g_md + const_m
    quad = inv_g @ v2.T - 2.0 * ((c * inv_g) @ v.T) + const_m[:, None]
    return -0.5 * (d * _LOG_2PI + log_det_g[:, None] + quad)


@fp32_math()
def plda_score_matrix_device(plda: Plda, enroll, test, num_utts=None,
                             device: DeviceLike = "cuda") -> torch.Tensor:
    """Full (M, N) LLR matrix on ``device``, float32.

    The same math as the float64 `plda_score_matrix`; centring and the
    diagonalising projection happen inside, so callers pass raw
    length-normalised vectors (M, D) and (N, D)."""
    dev = resolve_device(device)
    mean, t, psi = (_f32(a, dev) for a in (plda.mean, plda.transform, plda.psi))
    d = int(psi.shape[0])
    u = (_f32(enroll, dev) - mean) @ t.T
    v = (_f32(test, dev) - mean) @ t.T
    n = (torch.ones(u.shape[0], device=dev) if num_utts is None else _f32(num_utts, dev))
    log_given = _llr_block(psi, u, n, v * v, v, d)
    var_without = 1.0 + psi
    log_without = -0.5 * (d * _LOG_2PI + torch.sum(torch.log(var_without))
                          + torch.sum(v * v / var_without[None, :], dim=1))  # (N,)
    return log_given - log_without[None, :]


def plda_score_matrix_sharded(plda: Plda, enroll, test, mesh, num_utts=None,
                              axis: str = "data") -> torch.Tensor:
    """(M, N) LLR matrix with the enrollment models sharded over the mesh's
    ``axis``: the models are padded to ceil(M / n) * n rows (count 1), rank
    i scores block i against the whole test set with
    `plda_score_matrix_device` on its own device, and the blocks are
    gathered, so every rank returns the (M, N) float32 matrix."""
    from ..parallel.mesh import all_gather_rows, data_group, mesh_device

    group = data_group(mesh, axis)
    n_dev, idx = mesh[axis].size(), mesh.get_local_rank(axis)
    if isinstance(enroll, torch.Tensor):
        enroll = enroll.detach().cpu()
    enroll = np.asarray(enroll, np.float32)
    m = enroll.shape[0]
    per = -(-m // n_dev)
    e = np.zeros((per * n_dev, enroll.shape[1]), np.float32)
    e[:m] = enroll
    n = np.ones(per * n_dev, np.float32)
    if num_utts is not None:
        n[:m] = np.asarray(num_utts, np.float32)
    blk = slice(idx * per, (idx + 1) * per)
    local = plda_score_matrix_device(plda, e[blk], test, n[blk], device=mesh_device(mesh))
    return all_gather_rows(local, group)[:m]


# --------------------------------------------------------------------------
# Scatter statistics (the E-step shape shared by LDA and the PLDA init)
# --------------------------------------------------------------------------


def encode_labels(labels: Sequence) -> Tuple[np.ndarray, int]:
    """Stable integer encoding of hashable class labels, in order of first
    appearance."""
    uniq: dict = {}
    ids = np.empty(len(labels), np.int32)
    for i, lab in enumerate(labels):
        ids[i] = uniq.setdefault(lab, len(uniq))
    return ids, len(uniq)


@fp32_math()
def scatter_stats_device(vectors, label_ids, num_classes: int, device: DeviceLike = "cuda"):
    """Per-class statistics on ``device``: (class_sums (K, D), class_counts
    (K,), sw (D, D), mean (D,)), float32 tensors.

    sw is the within-class scatter sum_k sum_i (x - m_k)(x - m_k)',
    computed as X'X - sum_k n_k m_k m_k'.  The class sums are one-hot
    GEMMs over blocks of rows, in a fixed order."""
    dev = resolve_device(device)
    x = _f32(vectors, dev)
    ids = torch.as_tensor(np.asarray(label_ids), device=dev).long()
    n = x.shape[0]
    sums = torch.zeros((num_classes, x.shape[1]), device=dev)
    for i in range(0, n, _SEGMENT_ROWS):
        onehot = torch.nn.functional.one_hot(ids[i:i + _SEGMENT_ROWS], num_classes)
        sums += onehot.to(torch.float32).T @ x[i:i + _SEGMENT_ROWS]
    counts = torch.bincount(ids, minlength=num_classes).to(torch.float32)
    mean = torch.sum(sums, dim=0) / n
    gram = x.T @ x  # (D, D)
    means_k = sums / torch.clamp(counts, min=1.0)[:, None]
    sw = gram - (counts[:, None] * means_k).T @ means_k
    return sums, counts, sw, mean


# --------------------------------------------------------------------------
# PLDA EM on the device
# --------------------------------------------------------------------------


def _plda_em_iteration(phi_b, phi_w, means, counts, sw, n_total: float, block: int = 512):
    """One EM iteration.  Speakers go in blocks of ``block`` (the last one
    may be shorter), so the (block, D, D) posterior covariances bound
    memory; the blocks' sums are added in order."""
    d = phi_b.shape[0]
    k = means.shape[0]
    inv_b = torch.linalg.inv(phi_b)
    inv_w = torch.linalg.inv(phi_w)
    sum_cov = torch.zeros_like(phi_b)
    sum_resid = torch.zeros_like(phi_b)
    wtw = torch.zeros_like(phi_b)
    for i in range(0, k, block):
        m_blk, c_blk = means[i:i + block], counts[i:i + block]
        lam = inv_b[None] + c_blk[:, None, None] * inv_w[None]  # (b, D, D)
        cov = torch.linalg.inv(lam)
        # posterior means w = (c m) inv_w cov, per speaker
        w = torch.einsum("bd,bde->be", (m_blk * c_blk[:, None]) @ inv_w, cov)
        sum_cov += torch.sum(cov, dim=0)
        diff = m_blk - w
        sum_resid += (c_blk[:, None] * diff).T @ diff + torch.einsum("b,bde->de", c_blk, cov)
        wtw += w.T @ w
    eye = torch.eye(d, device=phi_b.device)
    phi_b_new = (sum_cov + wtw) / k + 1e-10 * eye
    phi_w_new = (sw + sum_resid) / n_total + 1e-10 * eye
    return phi_b_new, phi_w_new


@fp32_math()
def train_plda_device(vectors, labels: Sequence, num_iters: int = 10, block: int = 512,
                      device: DeviceLike = "cuda") -> Plda:
    """Two-covariance PLDA EM with the E-steps on ``device``.

    The same model and initialisation as the float64 `train_plda`; the
    per-iteration posterior solves and reductions run in float32.  The
    diagonalisation is one small (D, D) eigendecomposition on the host in
    float64."""
    dev = resolve_device(device)
    ids, k = encode_labels(labels)
    if k < 2:
        raise ValueError("PLDA needs >= 2 speakers")
    x = np.asarray(vectors, np.float32)
    n_total, d = x.shape
    sums, counts, sw, mean = (a.cpu().numpy() for a in scatter_stats_device(x, ids, k, dev))
    means = sums / counts[:, None] - mean[None, :]

    # init as train_plda: between = biased covariance of the class means,
    # within = pooled scatter / (N - K)
    mc = means - means.mean(axis=0)
    phi_b = (mc.T @ mc) / k + 1e-6 * np.eye(d)
    phi_w = sw / max(n_total - k, 1) + 1e-6 * np.eye(d)

    phi_b_t, phi_w_t, means_t, counts_t, sw_t = (
        _f32(a, dev) for a in (phi_b, phi_w, means, counts, sw))
    for _ in range(num_iters):
        phi_b_t, phi_w_t = _plda_em_iteration(phi_b_t, phi_w_t, means_t, counts_t, sw_t,
                                              float(n_total), block=min(block, max(k, 1)))

    phi_b = phi_b_t.cpu().numpy().astype(np.float64)
    phi_w = phi_w_t.cpu().numpy().astype(np.float64)
    # symmetrise the float32 rounding before the host eigh
    phi_b = 0.5 * (phi_b + phi_b.T)
    phi_w = 0.5 * (phi_w + phi_w.T)
    return _diagonalize(np.asarray(mean, np.float64), phi_b, phi_w)


# --------------------------------------------------------------------------
# LDA on the device
# --------------------------------------------------------------------------


def compute_lda_device(vectors, labels: Sequence, lda_dim: int,
                       total_covariance_factor: float = 0.0,
                       device: DeviceLike = "cuda") -> LdaTransform:
    """`ivector-compute-lda` with the O(N D^2) scatter on ``device``; the
    small (D, D) whitening and eigh stay on the host in float64.  Returns
    the same `LdaTransform` as the numpy `compute_lda`."""
    x = np.asarray(vectors, np.float32)
    n, d = x.shape
    if lda_dim > d:
        raise ValueError(f"lda_dim {lda_dim} > feature dim {d}")
    ids, k = encode_labels(labels)
    if k <= lda_dim:
        raise ValueError(f"need > lda_dim={lda_dim} classes, got {k}")

    sums, counts, sw, mean = (a.cpu().numpy().astype(np.float64)
                              for a in scatter_stats_device(x, ids, k, device))
    # class means about the global mean; sb = sum_k n_k m_k m_k'
    means_k = sums / counts[:, None] - mean[None, :]
    sb = np.einsum("k,kd,ke->de", counts, means_k, means_k)
    sw /= n
    sb /= n

    st = sw + sb
    w = (1.0 - total_covariance_factor) * sw + total_covariance_factor * st
    evals, evecs = np.linalg.eigh(w)
    floor = max(evals.max() * 1e-10, 1e-12)
    inv_sqrt = evecs @ np.diag(1.0 / np.sqrt(np.maximum(evals, floor))) @ evecs.T
    b_white = inv_sqrt @ sb @ inv_sqrt
    bvals, bvecs = np.linalg.eigh(b_white)
    order = np.argsort(bvals)[::-1][:lda_dim]
    proj = bvecs[:, order].T @ inv_sqrt
    return LdaTransform(projection=proj, mean=mean)
