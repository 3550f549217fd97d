"""Energy-based voice activity detection (compute-vad compatible).

Port of `sepi_tpu/ops/vad.py:energy_vad` (kaldi
ivector/voice-activity-detection.cc semantics):
  threshold = energy_threshold + energy_mean_scale * mean(log_E over utt)
  frame t is voiced iff, within [t-C, t+C] clipped to the utterance, at
  least ``proportion_threshold`` of the examined frames have
  log_E > threshold.
Padding frames count in neither numerator nor denominator.

The GMM-based variant (`sid/compute_vad_decision_gmm.sh`): per-frame
log-likelihoods under class GMMs (speech / non-speech; the classical
stack's GEMM-shaped `log_likes`), one argmax per frame mapped to a
decision (`compute-vad-from-frame-likes`), optionally intersected with
the energy VAD (`merge-vads`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import VadConfig
from ..device import DeviceLike


def _window_sum(x: torch.Tensor, context: int) -> torch.Tensor:
    """Sum of x over [t-context, t+context] per t; x: (B, T) float32."""
    if context == 0:
        return x
    k = 2 * context + 1
    ones = torch.ones((1, 1, k), dtype=x.dtype, device=x.device)
    return F.conv1d(x[:, None, :], ones, padding=context)[:, 0, :]


def energy_vad(log_energy: torch.Tensor, frame_mask: torch.Tensor,
               cfg: VadConfig = VadConfig()) -> torch.Tensor:
    """(B, T) or (T,) log energies + validity mask -> bool voiced mask."""
    squeeze = log_energy.ndim == 1
    if squeeze:
        log_energy, frame_mask = log_energy[None], frame_mask[None]
    mask_f = frame_mask.to(torch.float32)
    denom = torch.clamp(mask_f.sum(1, keepdim=True), min=1.0)
    mean_e = (log_energy * mask_f).sum(1, keepdim=True) / denom
    threshold = cfg.energy_threshold + cfg.energy_mean_scale * mean_e
    above = (log_energy > threshold).to(torch.float32) * mask_f
    num = _window_sum(above, cfg.frames_context)
    den = _window_sum(mask_f, cfg.frames_context)
    voiced = (num >= cfg.proportion_threshold * torch.clamp(den, min=1.0)) & frame_mask.bool()
    return voiced[0] if squeeze else voiced


def vad_from_frame_likes(frame_likes: torch.Tensor, frame_mask: torch.Tensor,
                         speech_classes=(0,), priors=None) -> torch.Tensor:
    """compute-vad-from-frame-likes: (K, T) or (B, K, T) per-class frame
    log-likelihoods -> bool voiced mask shaped like ``frame_mask``.
    ``speech_classes``: classes whose win maps to voiced; ``priors``:
    optional length-K log-prior offsets."""
    squeeze = frame_likes.ndim == 2
    if squeeze:
        frame_likes, frame_mask = frame_likes[None], frame_mask[None]
    ll = frame_likes
    if priors is not None:
        ll = ll + torch.as_tensor(priors, dtype=ll.dtype, device=ll.device)[None, :, None]
    best = torch.argmax(ll, dim=1)  # (B, T)
    speech = torch.zeros(ll.shape[1], dtype=torch.bool, device=ll.device)
    speech[torch.as_tensor(list(speech_classes), device=ll.device)] = True
    voiced = speech[best] & frame_mask.bool()
    return voiced[0] if squeeze else voiced


def merge_vads(vad_a: torch.Tensor, vad_b: torch.Tensor) -> torch.Tensor:
    """merge-vads with the intersection map: voiced only where both agree."""
    return vad_a & vad_b


def train_vad_gmms(frames, voiced, num_comps: int = 8, num_iters: int = 4, seed: int = 0,
                   device: DeviceLike = "cuda"):
    """Per-class diag GMMs bootstrapped from an energy-VAD labelling: one
    EM-trained GMM on the voiced frames and one on the rest.  Returns
    [speech_gmm, nonspeech_gmm] on ``device`` for `gmm_vad`."""
    import numpy as np

    from ..classical.gmm import _mstep_diag, accumulate_stats, init_diag_from_frames
    from ..config import UbmConfig

    frames = np.asarray(frames)
    voiced = np.asarray(voiced, bool)
    gmms = []
    cfg = UbmConfig(num_gauss=num_comps, num_gselect=num_comps)
    for sel in (voiced, ~voiced):
        x = frames[sel]
        if len(x) < num_comps * 4:
            raise ValueError(f"too few frames ({len(x)}) to train a VAD class GMM")
        floor = float(np.var(x, axis=0).mean()) * 1e-4 + 1e-8
        g = init_diag_from_frames(x, num_comps, seed, device)
        xt = torch.as_tensor(np.asarray(x, np.float32), device=g.means.device)
        for _ in range(num_iters):
            stats = accumulate_stats(g, xt, num_gselect=num_comps)
            g = _mstep_diag(stats, cfg, floor)
        gmms.append(g)
    return gmms


def gmm_vad(feats: torch.Tensor, frame_mask: torch.Tensor, class_gmms, speech_classes=(0,),
            priors=None, energy_voiced=None) -> torch.Tensor:
    """GMM-based VAD decision for one utterance (T, D).  ``class_gmms``:
    models exposing ``log_likes`` (index 0 = speech, the `train_vad_gmms`
    convention); with ``energy_voiced`` the result is intersected as
    `merge-vads` does."""
    ll = torch.stack([torch.logsumexp(g.log_likes(feats), dim=-1)
                      for g in class_gmms])  # (K, T)
    voiced = vad_from_frame_likes(ll, frame_mask, speech_classes, priors)
    if energy_voiced is not None:
        voiced = merge_vads(voiced, energy_voiced)
    return voiced
