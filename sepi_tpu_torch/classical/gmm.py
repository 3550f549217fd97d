"""GMM-UBM training: diagonal and full-covariance EM.

Port of `sepi_tpu/classical/gmm.py` (the Kaldi binaries behind
`sid/train_diag_ubm.sh` / `sid/train_full_ubm.sh`: gmm-global-init-from-
feats, gmm-gselect, gmm-global-acc-stats/-est, gmm-global-to-fgmm,
fgmm-global-acc-stats/-est, fgmm-global-init-from-accs).

The E-step is GEMMs on the model's device:
- diagonal log-likelihoods are two matmuls;
- full-covariance log-likelihoods whiten every frame by every
  component's inverse Cholesky factor in one GEMM, x (N, D) against the
  factors laid out (K*D, D), over bounded frame chunks (the (N, K, D)
  product is 2 GB at 4096 x 2048 x 60);
- gselect keeps Kaldi's top-N + min-post semantics as a dense mask: a
  frame keeps every component whose log-likelihood reaches its N-th
  largest, ties included;
- full second-order statistics are post' @ vec(x x'), never an (N, K, D)
  or (N, K, D, D) tensor.
The M-steps and the initialisation are host numpy, as in the reference.
Float32 throughout; callers run inside `device.fp32_math` so no product
drops to TF32.  `accumulate_stats_sharded` is the map-reduce E-step over
a device mesh: each rank accumulates its block of the frames, and one
all-reduce sums the statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import UbmConfig
from ..device import DeviceLike, resolve_device

_LOG_2PI = float(np.log(2.0 * np.pi))
# elements of the (rows, K, D) whitened block one full-covariance chunk holds
_WHITEN_ELEMS = 1 << 28


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass
class DiagGmm:
    weights: torch.Tensor  # (K,)
    means: torch.Tensor  # (K, D)
    vars: torch.Tensor  # (K, D) diagonal covariances

    @property
    def num_comp(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def to(self, device: DeviceLike) -> "DiagGmm":
        return DiagGmm(*(a.to(device) for a in (self.weights, self.means, self.vars)))

    def _prepared(self):
        inv_v = 1.0 / self.vars
        const = torch.log(self.weights) - 0.5 * (
            torch.sum(torch.log(self.vars), dim=1)
            + self.dim * _LOG_2PI
            + torch.sum(self.means ** 2 * inv_v, dim=1)
        )  # (K,)
        return const, (self.means * inv_v).T, (0.5 * inv_v).T

    def _log_likes(self, x: torch.Tensor, prep) -> torch.Tensor:
        const, lin_w, quad_w = prep
        return const[None, :] + x @ lin_w - (x * x) @ quad_w

    def log_likes(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D) -> (N, K) per-component log p(x, k): two GEMMs."""
        return self._log_likes(x, self._prepared())


@dataclasses.dataclass
class FullGmm:
    weights: torch.Tensor  # (K,)
    means: torch.Tensor  # (K, D)
    covars: torch.Tensor  # (K, D, D)

    @property
    def num_comp(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def to(self, device: DeviceLike) -> "FullGmm":
        return FullGmm(*(a.to(device) for a in (self.weights, self.means, self.covars)))

    def _whitener(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """inv-chol (K, D, D) and log-normalizers (K,)."""
        chol = torch.linalg.cholesky(self.covars)
        eye = torch.eye(self.dim, dtype=chol.dtype, device=chol.device)
        inv_chol = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=1, dim2=2)), dim=1)
        const = torch.log(self.weights) - 0.5 * (logdet + self.dim * _LOG_2PI)
        return inv_chol, const

    def _prepared(self):
        inv_chol, const = self._whitener()
        k, d = self.means.shape
        zm = torch.einsum("kde,ke->kd", inv_chol, self.means)
        return inv_chol.reshape(k * d, d).T, zm, const

    def _log_likes(self, x: torch.Tensor, prep) -> torch.Tensor:
        w_flat, zm, const = prep
        k, d = zm.shape
        rows = max(1, _WHITEN_ELEMS // (k * d))
        out = []
        with torch.no_grad():
            for s in range(0, x.shape[0], rows):
                z = (x[s:s + rows] @ w_flat).reshape(-1, k, d)
                z.sub_(zm[None])
                out.append(const[None, :] - 0.5 * torch.sum(z.mul_(z), dim=-1))
        return out[0] if len(out) == 1 else torch.cat(out)

    def log_likes(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D) -> (N, K): whitening GEMM + square-reduce."""
        return self._log_likes(x, self._prepared())


def gselect_posteriors(log_likes: torch.Tensor, num_gselect: int,
                       min_post: float = 0.0) -> torch.Tensor:
    """Kaldi gselect+min-post posterior pruning as a dense mask: posteriors
    renormalised over the components at or above each frame's
    ``num_gselect``-th largest log-likelihood (ties keep more), then
    entries < min_post dropped and renormalised again.  (..., K) -> dense
    (..., K), zeros outside the shortlist."""
    k = log_likes.shape[-1]
    n_sel = min(num_gselect, k)
    kth = torch.topk(log_likes, n_sel, dim=-1).values[..., -1:]
    masked = torch.where(log_likes >= kth, log_likes,
                         torch.full_like(log_likes, -float("inf")))
    post = torch.softmax(masked, dim=-1)
    if min_post > 0.0:
        post = torch.where(post >= min_post, post, torch.zeros_like(post))
        post = post / torch.clamp(post.sum(-1, keepdim=True), min=1e-20)
    return post


@dataclasses.dataclass
class GmmStats:
    """Zero/first/second-order sufficient statistics."""

    gamma: torch.Tensor  # (K,)
    first: torch.Tensor  # (K, D)
    second: torch.Tensor  # diag: (K, D);  full: (K, D, D)


def _outer_flat(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, D*D) rows vec(x x')."""
    return (x[:, :, None] * x[:, None, :]).reshape(x.shape[0], -1)


def accumulate_stats(gmm, x, num_gselect: int = 0, min_post: float = 0.0, full: bool = False,
                     chunk: int = 4096, valid: Optional[torch.Tensor] = None) -> GmmStats:
    """E-step accumulation over frames in chunks of ``chunk`` rows, on the
    model's device.  ``valid``: optional (N,) bool; rows marked False
    contribute nothing."""
    dev = gmm.means.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    k, d = gmm.means.shape
    prep = gmm._prepared()
    gamma = torch.zeros(k, device=dev)
    first = torch.zeros(k, d, device=dev)
    second = torch.zeros((k, d, d) if full else (k, d), device=dev)
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).to(torch.float32)
    with torch.no_grad():
        for s in range(0, x.shape[0], chunk):
            xb = x[s:s + chunk]
            ll = gmm._log_likes(xb, prep)
            if num_gselect > 0:
                post = gselect_posteriors(ll, num_gselect, min_post)
            else:
                post = torch.softmax(ll, dim=1)
            if valid is not None:
                post = post * valid[s:s + chunk, None]
            gamma += post.sum(0)
            first += post.T @ xb
            if full:
                second += (post.T @ _outer_flat(xb)).reshape(k, d, d)
            else:
                second += post.T @ (xb * xb)
    return GmmStats(gamma, first, second)


def accumulate_stats_sharded(gmm, x, mesh, num_gselect: int = 0, min_post: float = 0.0,
                             full: bool = False, chunk: int = 4096,
                             axis: str = "data") -> GmmStats:
    """Map-reduce E-step over the mesh's ``axis`` (the shape of
    `sid/train_ivector_extractor.sh:131-149` / `train_full_ubm.sh:97-108`,
    with one all-reduce for the `*-sum-accs` file tree).  Every rank passes
    the same frames ``x`` (N, D) and a model on its own device; the frames
    are padded to ceil(N / n) * n rows, rank i accumulates block i with the
    padding marked invalid, and the sums come back on every rank.  Equal to
    `accumulate_stats` up to summation order."""
    from ..parallel.mesh import data_group, reduce_sum_

    group = data_group(mesh, axis)
    n_dev, idx = mesh[axis].size(), mesh.get_local_rank(axis)
    dev = gmm.means.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[0]
    per = -(-n // n_dev)
    lo, hi = idx * per, min((idx + 1) * per, n)
    xl = torch.zeros((per, x.shape[1]), device=dev)
    valid = torch.zeros(per, dtype=torch.bool, device=dev)
    if hi > lo:
        xl[:hi - lo] = x[lo:hi]
        valid[:hi - lo] = True
    stats = accumulate_stats(gmm, xl, num_gselect, min_post, full, min(chunk, per), valid=valid)
    reduce_sum_([stats.gamma, stats.first, stats.second], group)
    return stats


# Components with fewer effective frames than this keep their previous
# parameters in the M-step: a starved component's moment estimates are
# garbage (negative "variances" from catastrophic cancellation), which
# would poison the Cholesky whitener with NaNs at 2048-component scale.
_MIN_COUNT = 5.0


def _mstep_diag(stats: GmmStats, cfg: UbmConfig, var_floor: float,
                prev: Optional[DiagGmm] = None) -> DiagGmm:
    dev = stats.gamma.device
    gamma = _np(stats.gamma)
    total = gamma.sum()
    w = np.maximum(gamma / max(total, 1e-20), cfg.min_gaussian_weight)
    w = w / w.sum()
    denom = np.maximum(gamma, 1e-10)[:, None]
    means = _np(stats.first) / denom
    vars_ = _np(stats.second) / denom - means ** 2
    vars_ = np.maximum(vars_, var_floor)
    low = gamma < _MIN_COUNT
    if np.any(low) and prev is not None:
        means[low] = _np(prev.means)[low]
        vars_[low] = _np(prev.vars)[low]
    return DiagGmm(_tensor(w, dev), _tensor(means, dev), _tensor(vars_, dev))


def _mstep_full(stats: GmmStats, cfg: UbmConfig, var_floor: float,
                prev: Optional[FullGmm] = None) -> FullGmm:
    dev = stats.gamma.device
    gamma = _np(stats.gamma)
    total = gamma.sum()
    w = np.maximum(gamma / max(total, 1e-20), cfg.min_gaussian_weight)
    w = w / w.sum()
    denom = np.maximum(gamma, 1e-10)
    means = _np(stats.first) / denom[:, None]
    d = means.shape[1]
    covars = _np(stats.second) / denom[:, None, None] - np.einsum("kd,ke->kde", means, means)
    covars += var_floor * np.eye(d)[None]
    low = gamma < max(_MIN_COUNT, d / 2.0)  # full-cov needs more mass
    if np.any(low):
        if prev is not None:
            means[low] = _np(prev.means)[low]
            covars[low] = _np(prev.covars)[low]
        else:
            global_cov = (np.cov(means[~low].T) + var_floor * np.eye(d)
                          if (~low).sum() > d else np.eye(d))
            covars[low] = global_cov
    # PSD safety: symmetric
    covars = 0.5 * (covars + np.swapaxes(covars, 1, 2))
    return FullGmm(_tensor(w, dev), _tensor(means, dev), _tensor(covars, dev))


def init_diag_from_frames(x: np.ndarray, num_comp: int, seed: int = 0,
                          device: DeviceLike = "cuda") -> DiagGmm:
    """gmm-global-init-from-feats: means from random frames, shared var
    (host numpy; the model lands on ``device``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, size=min(num_comp, n), replace=False)
    means = np.asarray(x[idx], np.float64)
    if len(idx) < num_comp:  # duplicate with jitter if too few frames
        extra = means[rng.integers(0, len(idx), num_comp - len(idx))]
        means = np.concatenate([means, extra + rng.normal(scale=1e-2, size=extra.shape)])
    gvar = np.maximum(np.var(np.asarray(x, np.float64), axis=0), 1e-4)
    k = num_comp
    return DiagGmm(torch.full((k,), 1.0 / k, device=dev), _tensor(means, dev),
                   _tensor(np.tile(gvar, (k, 1)), dev))


def train_diag_ubm(frames: np.ndarray, cfg: UbmConfig = UbmConfig(), seed: int = 0,
                   device: DeviceLike = "cuda") -> DiagGmm:
    """sid/train_diag_ubm.sh: init-from-feats + gselect EM iterations."""
    dev = resolve_device(device)
    x_np = np.asarray(frames[::cfg.subsample], np.float32)
    x = torch.as_tensor(x_np, device=dev)
    var_floor = float(np.var(frames, axis=0).mean()) * 1e-4 + 1e-6
    gmm = init_diag_from_frames(x_np, cfg.num_gauss, seed, dev)
    for _ in range(cfg.num_iters_init):
        stats = accumulate_stats(gmm, x, num_gselect=cfg.num_gselect, full=False)
        gmm = _mstep_diag(stats, cfg, var_floor, prev=gmm)
    return gmm


def diag_to_full(gmm: DiagGmm) -> FullGmm:
    """gmm-global-to-fgmm."""
    return FullGmm(gmm.weights, gmm.means, torch.diag_embed(gmm.vars))


def train_full_ubm(frames: np.ndarray, diag: DiagGmm,
                   cfg: UbmConfig = UbmConfig()) -> FullGmm:
    """sid/train_full_ubm.sh: full-cov EM from the diag UBM, on its device."""
    x = torch.as_tensor(np.asarray(frames[::cfg.subsample], np.float32),
                        device=diag.means.device)
    var_floor = float(np.var(frames, axis=0).mean()) * 1e-4 + 1e-6
    gmm = diag_to_full(diag)
    for _ in range(cfg.num_iters_full):
        stats = accumulate_stats(gmm, x, num_gselect=cfg.full_gselect, min_post=0.0, full=True)
        gmm = _mstep_full(stats, cfg, var_floor, prev=gmm)
    return gmm


def full_gmm_from_posteriors(frames: np.ndarray, posteriors: np.ndarray,
                             var_floor: float = 1e-4, device: DeviceLike = "cuda",
                             chunk: int = 16384) -> FullGmm:
    """init_full_ubm_from_dnn.sh / fgmm-global-init-from-accs: a full-cov
    GMM from externally supplied per-frame posteriors (e.g. the AM net's
    senone softmax).  Host rows go to ``device`` ``chunk`` at a time."""
    dev = resolve_device(device)
    n, d = frames.shape
    k = posteriors.shape[1]
    gamma = torch.zeros(k, device=dev)
    first = torch.zeros(k, d, device=dev)
    second = torch.zeros(k, d * d, device=dev)
    with torch.no_grad():
        for s in range(0, n, chunk):
            x = _tensor(frames[s:s + chunk], dev)
            post = _tensor(posteriors[s:s + chunk], dev)
            gamma += post.sum(0)
            first += post.T @ x
            second += post.T @ _outer_flat(x)
    stats = GmmStats(gamma, first, second.reshape(k, d, d))
    return _mstep_full(stats, UbmConfig(num_gauss=k), var_floor)
