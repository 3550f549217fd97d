"""Energy-based voice activity detection (compute-vad compatible).

Port of `sepi_tpu/ops/vad.py:energy_vad` (kaldi
ivector/voice-activity-detection.cc semantics):
  threshold = energy_threshold + energy_mean_scale * mean(log_E over utt)
  frame t is voiced iff, within [t-C, t+C] clipped to the utterance, at
  least ``proportion_threshold`` of the examined frames have
  log_E > threshold.
Padding frames count in neither numerator nor denominator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import VadConfig


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
