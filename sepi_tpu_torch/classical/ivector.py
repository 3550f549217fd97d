"""i-vector (T-matrix) extractor: EM training and extraction.

Port of `sepi_tpu/classical/ivector.py` (`ivector-extractor-init/-acc-
stats/-est`, `ivector-extract` behind `sid/train_ivector_extractor.sh` /
`sid/extract_ivectors.sh`).

Model: frame x from component k ~ N(mu_k + T_k w, Sigma_k), w ~ N(0, I),
worked in per-component whitened space (T~_k = W_k T_k, W_k =
chol(Sigma_k)^-1):

  L_u = I + sum_k N_uk U_k,  U_k = T~_k' T~_k      (one (U, K) @ (K, M*M) GEMM)
  b_u = sum_k T~_k' W_k (F_uk - N_uk mu_k)          (one (U, K*D) @ (K*D, M) GEMM)
  w_u = L_u^-1 b_u,  cov_u = L_u^-1                  (batched Cholesky)

U_k is formed once per call and the utterances go through in batches, so
the (U, M, M) posterior matrices stay bounded beside the (K, M, M) U-matrix
(5.9 GB at 2048 x 600).  The posterior (U_k, L_u, b_u and the Cholesky
solves) is float64 from the float32 statistics and T, cast back to
float32: where the reference's float32 works the numbers are its own, and
where a component's T row is large L_u stays positive definite.  (Found on the H100 with the DNN/i-vector
variant at 4000 components: after one EM iteration L_u's eigenvalues
spread from 0.97 to 1e6, float32 rounding moved its entries by up to
0.44, and the float32 Cholesky failed for 229 of 960 utterances, where
the reference's returns NaN.)  The M-step solves T_k A_k = C_k for every
component as a batched float64 `torch.linalg.solve` on the device: the
reference's `np.linalg.solve` on the host computes the same float64
solve of the float32 accumulators (its ridge term is a float64 identity)
and casts back to float32.

Documented deviation kept from the reference: the zero-mean prior, not
Kaldi's w[0] prior offset (LDA/PLDA subtract the global mean, which
cancels it).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import IvectorConfig
from .gmm import FullGmm, gselect_posteriors

# elements of the (batch, M, M) float64 posterior matrices one utterance batch holds
_POSTERIOR_ELEMS = 1 << 25
_SOLVE_COMPONENTS = 256  # components per batched float64 solve


@dataclasses.dataclass
class IvectorStats:
    """Per-utterance Baum-Welch stats in whitened space."""

    n: torch.Tensor  # (U, K) zero-order
    f: torch.Tensor  # (U, K, D) whitened centered first-order


@dataclasses.dataclass
class IvectorExtractor:
    t: torch.Tensor  # (K, D, M) whitened-space total-variability matrix
    whitener: torch.Tensor  # (K, D, D) W_k = chol(Sigma_k)^-1
    means: torch.Tensor  # (K, D) UBM means (raw space)

    @property
    def ivector_dim(self) -> int:
        return self.t.shape[2]

    def to(self, device) -> "IvectorExtractor":
        return IvectorExtractor(*(a.to(device) for a in (self.t, self.whitener, self.means)))


def init_extractor(ubm: FullGmm, ivector_dim: int, seed: int = 0) -> IvectorExtractor:
    """The reference's random T: the same numpy draw, on the UBM's device."""
    inv_chol, _ = ubm._whitener()
    k, d = ubm.means.shape
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(k, d, ivector_dim)).astype(np.float32) * 0.1
    return IvectorExtractor(torch.as_tensor(t, device=ubm.means.device), inv_chol, ubm.means)


def utterance_stats(ext: IvectorExtractor, feats: torch.Tensor, mask: torch.Tensor,
                    post: torch.Tensor) -> IvectorStats:
    """feats (U, T, D) padded, mask (U, T), post (U, T, K) -> stats."""
    post = post * mask[..., None].to(post.dtype)
    n = post.sum(1)  # (U, K)
    f_raw = torch.bmm(post.transpose(1, 2), feats)  # (U, K, D)
    f_cent = f_raw - n[..., None] * ext.means[None]
    f_white = torch.einsum("kde,uke->ukd", ext.whitener, f_cent)
    return IvectorStats(n, f_white)


def _posterior_batches(ext: IvectorExtractor, stats: IvectorStats, posterior_scale: float,
                       with_cov: bool = True) -> Iterator[Tuple[slice, torch.Tensor,
                                                                Optional[torch.Tensor]]]:
    """(utterance slice, w (u, M), cov (u, M, M) or None) per batch."""
    k, d, m = ext.t.shape
    t64 = ext.t.double()
    u_mat = torch.bmm(t64.transpose(1, 2), t64).reshape(k, m * m)
    t_flat = t64.reshape(k * d, m)
    eye = torch.eye(m, dtype=torch.float64, device=ext.t.device)
    batch = max(1, _POSTERIOR_ELEMS // (m * m))
    num = stats.n.shape[0]
    for s in range(0, num, batch):
        sl = slice(s, min(s + batch, num))
        n = stats.n[sl] * posterior_scale
        f = stats.f[sl] * posterior_scale
        l_mat = eye[None] + (n.double() @ u_mat).reshape(-1, m, m)
        b = f.reshape(-1, k * d).double() @ t_flat
        chol = torch.linalg.cholesky(l_mat)
        w = torch.cholesky_solve(b[..., None], chol)[..., 0].float()
        cov = (torch.cholesky_solve(eye.expand_as(chol), chol).float() if with_cov
               else None)
        yield sl, w, cov


def posterior_ivectors(ext: IvectorExtractor, stats: IvectorStats,
                       posterior_scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched posterior (mean (U, M), covariance (U, M, M)) of w."""
    ws, covs = [], []
    with torch.no_grad():
        for _, w, cov in _posterior_batches(ext, stats, posterior_scale):
            ws.append(w)
            covs.append(cov)
    return torch.cat(ws), torch.cat(covs)


def _mstep_accumulate(ext: IvectorExtractor, stats: IvectorStats, w: torch.Tensor,
                      cov: torch.Tensor, a: Optional[torch.Tensor] = None,
                      c: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A_k = sum_u N_uk (cov_u + w w'), C_k = sum_u f_uk w', added into
    ``a`` and ``c`` in place when given (no (K, M, M) temporary per batch)."""
    k, d, m = ext.t.shape
    if a is None:
        a = torch.zeros(k, m, m, device=w.device)
        c = torch.zeros(k, d, m, device=w.device)
    wwt = (cov + w[:, :, None] * w[:, None, :]).reshape(-1, m * m)
    a.view(k, m * m).addmm_(stats.n.T, wwt)
    c.view(k * d, m).addmm_(stats.f.reshape(-1, k * d).T, w)
    return a, c


def _solve_t(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """T_k = C_k A_k^-1 for every k (ridge 1e-6 I), float64, cast to float32."""
    k, d, m = c.shape
    eye = 1e-6 * torch.eye(m, dtype=torch.float64, device=a.device)
    out = torch.empty_like(c)
    for s in range(0, k, _SOLVE_COMPONENTS):
        e = min(s + _SOLVE_COMPONENTS, k)
        sol = torch.linalg.solve(a[s:e].double() + eye, c[s:e].double().transpose(1, 2))
        out[s:e] = sol.transpose(1, 2).to(torch.float32)
    return out


def train_ivector_extractor(ext: IvectorExtractor, stats: IvectorStats,
                            cfg: IvectorConfig = IvectorConfig()) -> IvectorExtractor:
    """EM on precomputed utterance stats (``cfg.num_iters`` M-steps)."""
    with torch.no_grad():
        for _ in range(cfg.num_iters):
            a = c = None
            for sl, w, cov in _posterior_batches(ext, stats, cfg.posterior_scale):
                a, c = _mstep_accumulate(ext, IvectorStats(stats.n[sl], stats.f[sl]), w, cov,
                                         a, c)
            ext = IvectorExtractor(_solve_t(a, c), ext.whitener, ext.means)
    return ext


def extract_ivectors(ext: IvectorExtractor, stats: IvectorStats,
                     cfg: IvectorConfig = IvectorConfig()) -> np.ndarray:
    """Posterior-mean i-vectors, (U, M) on the host."""
    with torch.no_grad():
        ws = [w for _, w, _ in _posterior_batches(ext, stats, cfg.posterior_scale,
                                                  with_cov=False)]
    return torch.cat(ws).cpu().numpy()


def stats_from_features(ext: IvectorExtractor, ubm: FullGmm,
                        features: Mapping[str, np.ndarray],
                        cfg: IvectorConfig = IvectorConfig(), num_gselect: int = 20,
                        batch: int = 8,
                        posteriors: Optional[Mapping[str, np.ndarray]] = None,
                        ) -> Tuple[List[str], IvectorStats]:
    """Per-utterance stats with UBM gselect posteriors, on the extractor's
    device, over length-sorted groups of ``batch`` utterances.

    A group pads to its longest utterance: padded frames are masked out
    of every sum, so the numbers are the reference's, whose 256-frame
    padding grid only bounds JAX's compiled shapes.  ``posteriors`` (utt
    -> (T, K), frame-aligned with ``features``) replaces the UBM
    posteriors: the DNN/i-vector paired-stream split, where a senone net
    on hires features aligns frames to components and the sid features
    supply the stats."""
    dev = ext.t.device
    utt_ids = sorted(features, key=lambda u: (features[u].shape[0], u))
    prep = None if posteriors is not None else ubm._prepared()
    ns, fs = [], []
    with torch.no_grad():
        for i0 in range(0, len(utt_ids), batch):
            group = utt_ids[i0:i0 + batch]
            t_max = max(features[u].shape[0] for u in group)
            d = features[group[0]].shape[1]
            feats = np.zeros((len(group), t_max, d), np.float32)
            mask = np.zeros((len(group), t_max), bool)
            for j, u in enumerate(group):
                f = features[u]
                feats[j, :f.shape[0]] = f
                mask[j, :f.shape[0]] = True
            feats_t = torch.as_tensor(feats, device=dev)
            if posteriors is not None:
                k = next(iter(posteriors.values())).shape[1]
                post = np.zeros((len(group), t_max, k), np.float32)
                for j, u in enumerate(group):
                    p = posteriors[u]
                    if p.shape[0] != features[u].shape[0]:
                        raise ValueError(
                            f"{u}: posteriors rows {p.shape[0]} != frames "
                            f"{features[u].shape[0]} (paired streams must be frame-aligned)")
                    post[j, :p.shape[0]] = p
                post_t = torch.as_tensor(post, device=dev)
            else:
                ll = ubm._log_likes(feats_t.reshape(-1, d), prep)
                post_t = gselect_posteriors(ll, num_gselect, cfg.min_post).reshape(
                    len(group), t_max, -1)
            s = utterance_stats(ext, feats_t, torch.as_tensor(mask, device=dev), post_t)
            ns.append(s.n)
            fs.append(s.f)
    return utt_ids, IvectorStats(torch.cat(ns), torch.cat(fs))
