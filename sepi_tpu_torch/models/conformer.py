"""MFA-Conformer (Zhang et al., "MFA-Conformer: Multi-scale Feature
Aggregation Conformer for Automatic Speaker Verification", Interspeech
2022, arXiv:2203.15249), the 6-block system with 1/2 subsampling.

No counterpart in the JAX package: the port's own model, held by the
tests against the plain float64 reference `benchmark/reference/conformer.py`.
On (B, T, C) inside:

  input map  the fixed (feat_dim, feat_dim) inverse of the frontend's
             lifter and orthonormal DCT: log-mel = (c / lifter) DCT^-1
             (DCT^-1 = DCT^T but for the table's float32 rounding), the
             paper's filterbank input from the port's cepstra
  subsample  wenet's Conv2dSubsampling2: Conv2d(1, d, 3, stride 2), ReLU,
             Conv2d(d, d, 3), ReLU over (time, bins); the d x F' maps of a
             frame through a Linear to d, then x sqrt(d).  T' =
             (T - 1) // 2 - 2 frames, bins 80 -> 39 -> 37
  positions  ESPnet's RelPositionalEncoding: 2T' - 1 rows, row r the
             sinusoid of relative position T' - 1 - r
  blocks     Conformer blocks (Gulati et al., Interspeech 2020, §2),
             layer norm first, macaron:
               x += FF(LN x) / 2;  x += MHSA(LN x);  x += Conv(LN x);
               x += FF(LN x) / 2;  x = LN x
             FF: Linear d -> ff_dim, Swish, Linear to d.  MHSA: heads of
             d / heads, scores ((q + u) k^T + shift((q + v) p^T)) /
             sqrt(d / heads), p the positions through a Linear without
             bias (Dai et al., ACL 2019, §3.3, as ESPnet's
             RelPositionMultiHeadedAttention), padded keys masked.  Conv:
             pointwise d -> 2d, GLU, depthwise k = conv_kernel with zero
             "same" padding, BN, Swish, pointwise d -> d
  MFA        the blocks' outputs concatenated (num_blocks x d), LayerNorm
  pooling    attentive statistics (`ecapa.AttentiveStatsPool`) over the
             valid subsampled frames
  head       BN -> Linear to ``embed_dim`` -> BN: the embedding

Masking.  The subsampler's convolutions pad nothing, so a valid output
frame reads only valid input frames; a row of L valid frames has
(L - 1) // 2 - 2 valid subsampled ones (a prefix).  Padded input frames
are zeroed first, so what the padding held changes nothing; the keys past
a row's length take the softmax's floor, padded frames are zeroed before
the depthwise convolution, and the pooling reads the valid frames only:
a padded row equals its utterance run alone.

Attention memory.  The scores of one query are T' wide, so a whole
(B, H, T', 2T' - 1) matrix at the 10,000-frame bucket is 25.6 GB at 32
rows.  The attention runs in blocks of query rows (`query_rows`) whose
``ac`` (rows x T') and positional band ``bd`` (rows x (rows + T' - 1))
stay under ``ATTENTION_BLOCK_BYTES``; `ops.relpos_softmax` turns each
block into probabilities in one pass (the Triton kernel on the card),
and the three products stay on cuBLAS.  The positions are computed in
float64 and rounded once: a float32 argument of sin at position 5,000
would be off by ~3e-4.  ``aam`` holds the AAM-softmax weight of a later
training path; extraction does not read it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.features import dct_matrix, lifter_coeffs
from ..ops.relpos_softmax import relpos_softmax
from ..utils.logging import span
from .ecapa import AttentiveStatsPool, frame_masks
from .tdnn import BatchNorm

EPS_LN = 1e-5  # torch's LayerNorm default, as wenet's Conformer uses
EPS_BN = 1e-5
# the float32 ac and bd scores of one query block: a whole (B, H, T', 2T' - 1)
# matrix of a 32-row 10,000-frame bucket would be 25.6 GB
ATTENTION_BLOCK_BYTES = 1 << 31


@dataclasses.dataclass(frozen=True)
class MfaConformerConfig:
    feat_dim: int = 80  # cepstra in, of as many mel bins (the input map is square)
    cepstral_lifter: float = 22.0  # the frontend's lifter Q, undone by the input map
    d_model: int = 256
    num_blocks: int = 6
    num_heads: int = 4
    ff_dim: int = 2048
    conv_kernel: int = 15
    attention_bottleneck: int = 128
    embed_dim: int = 192
    num_speakers: int = 5994  # VoxCeleb2 dev: the AAM-softmax weight's rows

    @property
    def mfa_channels(self) -> int:
        return self.num_blocks * self.d_model

    @property
    def sub_bins(self) -> int:
        """The subsampler's bins out, by the frames' rule."""
        return subsampled_frames(self.feat_dim)


def subsampled_frames(frames):
    """Frames after the subsampler: (T - 1) // 2 - 2 (ints or tensors; may
    be negative below 7 frames)."""
    return (frames - 1) // 2 - 2


def input_map(feat_dim: int, lifter: float) -> torch.Tensor:
    """(feat_dim, feat_dim) float32 M with log-mel = cepstra @ M: the
    frontend's float32 DCT (bins x ceps) and lifter undone in float64."""
    dct = torch.from_numpy(dct_matrix(feat_dim, feat_dim)).double()
    lift = torch.from_numpy(lifter_coeffs(feat_dim, lifter)).double()
    return (torch.linalg.inv(dct) / lift[:, None]).float()


def relative_positions(t: int, dim: int, device: torch.device) -> torch.Tensor:
    """(2t - 1, dim) float32: row r holds position P = t - 1 - r as
    [sin(P w_0), cos(P w_0), sin(P w_1), ...], w_k = 10000^(-2k / dim)."""
    pos = torch.arange(t - 1, -t, -1, device=device, dtype=torch.float64)
    w = torch.exp(torch.arange(0, dim, 2, device=device, dtype=torch.float64)
                  * (-math.log(10000.0) / dim))
    ang = pos[:, None] * w[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(2 * t - 1, dim).float()


def query_rows(batch: int, heads: int, t: int, budget: int) -> int:
    """The most query rows Q (at most t; a multiple of 64 when below it and
    at least 64) whose float32 ``ac`` (batch x heads x Q x t) and band
    ``bd`` (batch x heads x Q x (Q + t - 1)) fit ``budget`` bytes."""
    per = 4 * batch * heads
    a = 2 * t - 1
    q = int((-a + math.sqrt(a * a + 4.0 * budget / per)) / 2)
    while q > 1 and q * (q + a) * per > budget:
        q -= 1
    q = max(1, min(t, q))
    if q < t and q >= 64:
        q -= q % 64
    return q


class Subsampling(nn.Module):
    """wenet's Conv2dSubsampling2, its output scaled by sqrt(d) as ESPnet's
    RelPositionalEncoding scales its input."""

    def __init__(self, cfg: MfaConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.conv1 = nn.Conv2d(1, d, 3, stride=2)
        self.conv2 = nn.Conv2d(d, d, 3)
        self.out = nn.Linear(d * cfg.sub_bins, d)
        self.scale = math.sqrt(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B, T', d)."""
        h = torch.relu_(self.conv1(x[:, None]))
        h2 = torch.relu_(self.conv2(h))
        del h
        # the Linear over each frame's (channel, bin) maps, as a convolution
        # spanning the bins: no transposed copy of the maps
        w = self.out.weight.view(self.out.out_features, h2.shape[1], 1, h2.shape[3])
        y = F.conv2d(h2, w, self.out.bias)[..., 0]  # (B, d, T')
        return y.mul_(self.scale).transpose(1, 2).contiguous()


class FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.w1 = nn.Linear(d, hidden)
        self.w2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x), inplace=True))


class RelPositionAttention(nn.Module):
    """Multi-head self-attention with Transformer-XL's relative positions,
    in blocks of query rows."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        if d % heads:
            raise ValueError(f"d_model {d} not divisible by {heads} heads")
        self.heads, self.dk = heads, d // heads
        self.qkv = nn.Linear(d, 3 * d)
        self.linear_pos = nn.Linear(d, d, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, self.dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, self.dk))
        self.linear_out = nn.Linear(d, d)
        self.scale = 1.0 / math.sqrt(self.dk)

    def forward(self, x: torch.Tensor, pe: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(B, T', d), the (2T' - 1, d) positions, (B,) int32 valid keys."""
        b, t, d = x.shape
        h, dk = self.heads, self.dk
        # (B, H, T', dk) each, contiguous: the blocks' products take them without copies
        q, k, v = self.qkv(x).view(b, t, 3, h, dk).permute(2, 0, 3, 1, 4).contiguous()
        p = self.linear_pos(pe).view(2 * t - 1, h, dk).permute(1, 2, 0)  # (H, dk, 2T' - 1)
        qu = q + self.pos_bias_u[:, None, :]
        qv = q + self.pos_bias_v[:, None, :]
        del q
        kt = k.transpose(-1, -2)
        out = torch.empty((b, t, h, dk), dtype=x.dtype, device=x.device)
        rows = query_rows(b, h, t, ATTENTION_BLOCK_BYTES)
        for i0 in range(0, t, rows):
            i1 = min(i0 + rows, t)
            n = i1 - i0
            ac = torch.matmul(qu[:, :, i0:i1], kt)  # (B, H, n, T')
            # the band of positions rows i0 .. i1 - 1 read: T' - i1 .. 2T' - 2 - i0;
            # one product per head over the batch's rows, (H, B n, dk) x (H, dk, n + T' - 1)
            qb = qv[:, :, i0:i1].transpose(0, 1).reshape(h, b * n, dk)
            bd = torch.bmm(qb, p[:, :, t - i1:2 * t - 1 - i0]).view(h, b, n, n + t - 1)
            probs = relpos_softmax(ac, bd.transpose(0, 1), lengths, self.scale)
            del bd, qb
            out[:, i0:i1] = torch.matmul(probs, v).transpose(1, 2)
            del ac, probs
        return self.linear_out(out.view(b, t, d))


class ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int):
        super().__init__()
        if kernel % 2 == 0:
            raise ValueError(f"conv_kernel {kernel} must be odd")
        self.pointwise1 = nn.Linear(d, 2 * d)
        self.depthwise = nn.Conv1d(d, d, kernel, padding=(kernel - 1) // 2, groups=d)
        self.bn = BatchNorm(d, eps=EPS_BN)
        self.pointwise2 = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
        """(B, T', d) -> (B, T', d); ``pad`` (B, T', 1) True past the valid frames."""
        g = F.glu(self.pointwise1(x), dim=-1).masked_fill_(pad, 0.0)
        y = F.silu(self.bn(self.depthwise(g.transpose(1, 2))), inplace=True)
        del g
        return self.pointwise2(y.transpose(1, 2))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: MfaConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.norm_ff1 = nn.LayerNorm(d, eps=EPS_LN)
        self.ff1 = FeedForward(d, cfg.ff_dim)
        self.norm_mhsa = nn.LayerNorm(d, eps=EPS_LN)
        self.mhsa = RelPositionAttention(d, cfg.num_heads)
        self.norm_conv = nn.LayerNorm(d, eps=EPS_LN)
        self.conv = ConvModule(d, cfg.conv_kernel)
        self.norm_ff2 = nn.LayerNorm(d, eps=EPS_LN)
        self.ff2 = FeedForward(d, cfg.ff_dim)
        self.norm_final = nn.LayerNorm(d, eps=EPS_LN)

    def forward(self, x: torch.Tensor, pe: torch.Tensor, lengths: torch.Tensor,
                pad: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ff1(self.norm_ff1(x))  # a new tensor: the caller keeps its x
        with span("conformer.mhsa"):
            x.add_(self.mhsa(self.norm_mhsa(x), pe, lengths))
        with span("conformer.conv"):
            x.add_(self.conv(self.norm_conv(x), pad))
        x.add_(self.ff2(self.norm_ff2(x)), alpha=0.5)
        return self.norm_final(x)


class MfaConformer(nn.Module):
    """``forward(feats (B, T, feat_dim), frame_mask (B, T))`` ->
    ``{"embedding": (B, embed_dim)}``, float32; the valid frames of a row
    are a prefix.  The stages are spans of `utils.logging`
    (``conformer.subsample``, ``conformer.block``, ``conformer.mhsa``,
    ``conformer.conv``, ``conformer.pool``), off unless tracing is on;
    inside a graph replay a span sees only the capture."""

    def __init__(self, cfg: MfaConformerConfig = MfaConformerConfig()):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("input_map", input_map(cfg.feat_dim, cfg.cepstral_lifter),
                             persistent=False)
        self.subsample = Subsampling(cfg)
        self.blocks = nn.ModuleList(ConformerBlock(cfg) for _ in range(cfg.num_blocks))
        self.mfa_norm = nn.LayerNorm(cfg.mfa_channels, eps=EPS_LN)
        self.pool = AttentiveStatsPool(cfg.mfa_channels, cfg.attention_bottleneck)
        self.pool_bn = BatchNorm(2 * cfg.mfa_channels, eps=EPS_BN)
        self.fc = nn.Linear(2 * cfg.mfa_channels, cfg.embed_dim)
        self.embed_bn = BatchNorm(cfg.embed_dim, eps=EPS_BN)
        self.aam = nn.Linear(cfg.embed_dim, cfg.num_speakers, bias=False)

    def forward(self, feats: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        b, t, _ = feats.shape
        if subsampled_frames(t) < 1:
            raise ValueError(f"MfaConformer: {t} frames, below the subsampler's 7")
        if frame_mask is None:
            frame_mask = torch.ones((b, t), dtype=torch.bool, device=feats.device)
        valid = frame_mask.bool()
        with span("conformer.subsample"):
            x = torch.matmul(feats.masked_fill(~valid[..., None], 0.0), self.input_map)
            x = self.subsample(x)
            ts = x.shape[1]
            lengths = torch.clamp(subsampled_frames(valid.sum(1)), min=0).to(torch.int32)
            keep_t = torch.arange(ts, device=x.device)[None, :] < lengths[:, None]
            pe = relative_positions(ts, self.cfg.d_model, x.device)
        pad_t = ~keep_t[..., None]
        outs: List[torch.Tensor] = []
        for block in self.blocks:
            with span("conformer.block"):
                x = block(x, pe, lengths, pad_t)
                outs.append(x)
        del x
        with span("conformer.pool"):
            h = self.mfa_norm(torch.cat(outs, dim=-1)).transpose(1, 2).contiguous()
            del outs
            pad, keep, count = frame_masks(keep_t, h.dtype)
            pooled = self.pool_bn(self.pool(h, pad, keep, count)[..., None])[..., 0]
            emb = self.embed_bn(self.fc(pooled)[..., None])[..., 0]
        return {"embedding": emb}
