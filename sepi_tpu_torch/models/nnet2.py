"""The legacy nnet2 p-norm multisplice TDNN (the DNN/i-vector posterior net).

Port of `sepi_tpu/models/nnet2.py` (`local/dnn/run_nnet2_multisplice.sh:
47-61`): splice indexes layer0 -2:-1:0:1:2, layer1 -1,2, layer3 -3,3,
layer4 -7,2; p-norm 3500 -> 350 (group 10, p = 2), softmax over senones.
It supplies the senone posteriors of the DNN-posterior UBM and i-vector
extractor (`init_full_ubm_from_dnn.sh:100-105`).

The p-norm unit: y_j = (sum_{i in group j} |x_i|^p)^(1/p), then rows
scaled to unit RMS (nnet2's NormalizeComponent).  The reference groups
*consecutive* channels of the channels-last affine output; here the
affine output is (B, C, T), so the channel axis is viewed as
(dim, group) in place and reduced over the group, never a transposed
tensor.  Inputs and outputs keep the reference's (B, T, C) layout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .tdnn import Stream, TdnnSpec, stack_context


class PnormLayer(nn.Module):
    """affine (spliced VALID Conv1d) -> group p-norm -> RMS normalise, on
    (B, C, T)."""

    def __init__(self, spec: TdnnSpec, in_dim: int, input_dim_multiple: int = 10,
                 p: float = 2.0):
        super().__init__()
        self.dim = spec.dim  # p-norm OUTPUT dim
        self.group = input_dim_multiple
        self.p = p
        self.affine = nn.Conv1d(in_dim, spec.dim * input_dim_multiple, spec.kernel_size,
                                dilation=spec.dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        affine = self.affine(x)
        b, _, t = affine.shape
        g = affine.view(b, self.dim, self.group, t)
        if self.p == 2.0:
            y = torch.sqrt(torch.sum(g * g, dim=2) + 1e-20)
        else:
            y = torch.sum(torch.abs(g) ** self.p, dim=2) ** (1.0 / self.p)
        # NormalizeComponent: scale each frame to unit RMS over channels
        rms = torch.sqrt(torch.mean(y * y, dim=1, keepdim=True) + 1e-20)
        return y / rms


@dataclasses.dataclass(frozen=True)
class Nnet2Config:
    """The run_nnet2_multisplice.sh architecture on 40-dim hires MFCC."""

    feat_dim: int = 40
    num_senones: int = 4000
    pnorm_output_dim: int = 350  # reference: 3500 -> 350 (group 10)
    group_size: int = 10
    specs: Tuple[TdnnSpec, ...] = (
        TdnnSpec(350, (-2, -1, 0, 1, 2)),  # layer0
        TdnnSpec(350, (-1, 2)),  # layer1 "-1:2"
        TdnnSpec(350, (0,)),  # layer2 (no splice)
        TdnnSpec(350, (-3, 3)),  # layer3
        TdnnSpec(350, (-7, 2)),  # layer4
    )

    @property
    def context(self) -> Tuple[int, int]:
        return stack_context(self.specs)  # (13, 9)


NNET2_MULTISPLICE = Nnet2Config()


class Nnet2Multisplice(nn.Module):
    """Layers ``layer0..4`` and the ``output`` Linear, Flax's names."""

    def __init__(self, cfg: Nnet2Config):
        super().__init__()
        self.cfg = cfg
        self.names = []
        in_dim = cfg.feat_dim
        for i, spec in enumerate(cfg.specs):
            spec = dataclasses.replace(spec, dim=cfg.pnorm_output_dim)
            self.add_module(f"layer{i}", PnormLayer(spec, in_dim, cfg.group_size))
            self.names.append(f"layer{i}")
            in_dim = cfg.pnorm_output_dim
        self.output = nn.Linear(cfg.pnorm_output_dim, cfg.num_senones)

    def forward(self, feats: torch.Tensor, train: bool = False):
        """(B, T, D) -> {"logits": (B, T', S), "context": (l, r), "stream"}."""
        x = feats.transpose(1, 2)
        for name in self.names:
            x = getattr(self, name)(x)
        x = x.transpose(1, 2)
        left, right = self.cfg.context
        return {"logits": self.output(x), "context": (left, right),
                "stream": Stream(x, left, right)}
