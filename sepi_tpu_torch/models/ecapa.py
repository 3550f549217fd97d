"""ECAPA-TDNN (Desplanques, Thienpondt and Demuynck, Interspeech 2020,
arXiv:2005.07143, §2-3 and Fig. 2), the C = 1024 system.

No counterpart in the JAX package: the port's own model, held by the
tests against the plain float64 reference `benchmark/reference/ecapa.py`.
On (B, C, T) inside, with "CRB" a Conv1d, ReLU, then `BatchNorm`:

  stem     CRB k = 5, feat_dim -> C
  blocks   three SE-Res2Blocks (k = 3, dilations 2, 3, 4): CRB k = 1;
           Res2 over ``scale`` groups (y1 = x1, y2 = K2(x2),
           yi = Ki(xi + y(i-1)), each Ki a dilated CRB); CRB k = 1; SE
           (sigmoid(W2 ReLU(W1 mean_t h))), scaling h; plus the block's
           input.  Block i's input is the sum of the stem's output and of
           every earlier block's (§3.3).
  MFA      the three blocks' outputs concatenated, Conv1d k = 1, ReLU
  pooling  attentive statistics: H_t = [h_t; mu; sigma],
           e = W2 tanh(BN(ReLU(W1 H_t))), alpha = softmax_t(e) per channel,
           [sum alpha h; sqrt(sum alpha h^2 - mu~^2)]
  head     BN -> Linear to ``embed_dim`` -> BN: the embedding

Convolutions pad to the same length with zeros.  In a padded bucket the
mask flows through the whole trunk: padded frames are zeroed before every
k > 1 convolution (batch norm's shift makes them non-zero again after each
layer), and the SE means, the global mu and sigma and the softmax read the
valid frames only, so a padded row equals its utterance run alone.  The
variances are taken about their means in two passes (the same value as
E[h^2] - mu^2, without its cancellation in float32).  ``aam`` holds the
AAM-softmax weight of a later training path; extraction does not read it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..utils.logging import span
from .tdnn import BatchNorm

EPS_BN = 1e-5  # torch's BatchNorm1d default, as ECAPA's public implementations train with
VAR_FLOOR = 1e-12  # floor of the pooled variances before the square root


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    feat_dim: int = 80
    channels: int = 1024
    stem_kernel: int = 5
    kernel: int = 3
    dilations: Tuple[int, ...] = (2, 3, 4)
    scale: int = 8
    se_bottleneck: int = 128
    attention_bottleneck: int = 128
    mfa_channels: int = 1536
    embed_dim: int = 192
    num_speakers: int = 5994  # VoxCeleb2 dev: the AAM-softmax weight's rows


class ConvBlock(nn.Module):
    """CRB: Conv1d (zero "same" padding, dilated) -> ReLU -> BatchNorm."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, dilation=dilation,
                              padding=dilation * (kernel - 1) // 2)
        self.bn = BatchNorm(cout, eps=EPS_BN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(torch.relu_(self.conv(x)))


def frame_masks(valid: torch.Tensor, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The masks of a (B, T) bool ``valid`` that `valid_mean` and
    `AttentiveStatsPool` read: ``pad`` (B, 1, T) True on the padded
    frames, ``keep`` (B, T, 1) 0/1 weights in ``dtype``, and ``count``
    (B, 1, 1) the valid frames, at least 1."""
    keep = valid.to(dtype)[:, :, None]
    return ~valid[:, None, :], keep, torch.clamp(keep.sum(1, keepdim=True), min=1.0)


def valid_mean(x: torch.Tensor, keep: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, C, 1): the mean over each row's valid frames, as
    one product with the (B, T, 1) 0/1 weights ``keep`` (no copy of x);
    ``x`` is finite on the padded frames."""
    return torch.bmm(x, keep) / count


class SeRes2Block(nn.Module):
    def __init__(self, channels: int, kernel: int, dilation: int, scale: int, bottleneck: int):
        super().__init__()
        if channels % scale:
            raise ValueError(f"channels {channels} not divisible by scale {scale}")
        width = channels // scale
        self.scale = scale
        self.conv1 = ConvBlock(channels, channels)
        self.res2 = nn.ModuleList(ConvBlock(width, width, kernel, dilation)
                                  for _ in range(scale - 1))
        self.conv2 = ConvBlock(channels, channels)
        self.se_squeeze = nn.Linear(channels, bottleneck)
        self.se_excite = nn.Linear(bottleneck, channels)

    def forward(self, x: torch.Tensor, pad: torch.Tensor, keep: torch.Tensor,
                count: torch.Tensor) -> torch.Tensor:
        groups = self.conv1(x).chunk(self.scale, dim=1)
        ys = [groups[0]]
        for i, conv in enumerate(self.res2, 1):
            z = groups[i] if i == 1 else groups[i] + ys[-1]
            ys.append(conv(z.masked_fill(pad, 0.0)))
        cat = torch.cat(ys, dim=1)
        del groups, ys  # the groups are views of conv1's output
        h = self.conv2(cat)
        del cat
        z = valid_mean(h, keep, count)[..., 0]
        s = torch.sigmoid(self.se_excite(torch.relu(self.se_squeeze(z))))
        return h.mul_(s[..., None]).add_(x)


class AttentiveStatsPool(nn.Module):
    """Channel- and context-dependent attentive statistics pooling:
    (B, C, T) -> (B, 2C), over the valid frames that `frame_masks`'
    ``pad``, ``keep`` and ``count`` give (the MFA-Conformer pools with it
    too, `models.conformer`)."""

    def __init__(self, channels: int, bottleneck: int):
        super().__init__()
        self.attn1 = nn.Conv1d(3 * channels, bottleneck, 1)
        self.attn_bn = BatchNorm(bottleneck, eps=EPS_BN)
        self.attn2 = nn.Conv1d(bottleneck, channels, 1)

    def forward(self, h: torch.Tensor, pad: torch.Tensor, keep: torch.Tensor,
                count: torch.Tensor) -> torch.Tensor:
        t = h.shape[-1]
        mu = valid_mean(h, keep, count)
        sq = (h - mu).masked_fill_(pad, 0.0).square_()
        sd = torch.sqrt(torch.clamp(sq.sum(-1, keepdim=True) / count, min=VAR_FLOOR))
        del sq
        hidden = self.attn1(torch.cat([h, mu.expand(-1, -1, t), sd.expand(-1, -1, t)], dim=1))
        e = self.attn2(torch.tanh_(self.attn_bn(torch.relu_(hidden))))
        # a finite floor, not -inf: a row with no valid frame (a bucket's
        # unused rows) stays finite
        alpha = torch.softmax(e.masked_fill_(pad, torch.finfo(e.dtype).min), dim=-1)
        del e
        mean = (alpha * h).sum(-1)
        var = (h - mean[..., None]).square_().mul_(alpha).sum(-1)
        return torch.cat([mean, torch.sqrt(torch.clamp(var, min=VAR_FLOOR))], dim=1)


class EcapaTdnn(nn.Module):
    """``forward(feats (B, T, feat_dim), frame_mask (B, T))`` ->
    ``{"embedding": (B, embed_dim)}``, float32.  The stages are spans of
    `utils.logging` (``ecapa.stem``, ``ecapa.block``, ``ecapa.mfa``,
    ``ecapa.pool``), off unless tracing is on; inside a graph replay a span
    sees only the capture."""

    def __init__(self, cfg: EcapaConfig = EcapaConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.stem = ConvBlock(cfg.feat_dim, c, cfg.stem_kernel)
        self.blocks = nn.ModuleList(
            SeRes2Block(c, cfg.kernel, d, cfg.scale, cfg.se_bottleneck) for d in cfg.dilations)
        self.mfa = nn.Conv1d(len(cfg.dilations) * c, cfg.mfa_channels, 1)
        self.pool = AttentiveStatsPool(cfg.mfa_channels, cfg.attention_bottleneck)
        self.pool_bn = BatchNorm(2 * cfg.mfa_channels, eps=EPS_BN)
        self.fc = nn.Linear(2 * cfg.mfa_channels, cfg.embed_dim)
        self.embed_bn = BatchNorm(cfg.embed_dim, eps=EPS_BN)
        self.aam = nn.Linear(cfg.embed_dim, cfg.num_speakers, bias=False)

    def forward(self, feats: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        x = feats.transpose(1, 2)
        if frame_mask is None:
            frame_mask = torch.ones(x.shape[0], x.shape[2], dtype=torch.bool, device=x.device)
        pad, keep, count = frame_masks(frame_mask.bool(), x.dtype)
        with span("ecapa.stem"):
            inp = self.stem(x.masked_fill(pad, 0.0))
        outs = []
        for block in self.blocks:
            with span("ecapa.block"):
                if outs:
                    inp = inp + outs[-1]
                outs.append(block(inp, pad, keep, count))
        del inp
        with span("ecapa.mfa"):
            h = torch.relu_(self.mfa(torch.cat(outs, dim=1)))
        del outs
        with span("ecapa.pool"):
            pooled = self.pool_bn(self.pool(h, pad, keep, count)[..., None])[..., 0]
            emb = self.embed_bn(self.fc(pooled)[..., None])[..., 0]
        return {"embedding": emb}
