"""ECAPA-TDNN (Desplanques et al., Interspeech 2020, arXiv:2005.07143), the
C = 1024 system: a kind of model, found by a configuration's
``"model": "ecapa"``.

Its configuration holds the widths of `sepi_tpu_torch.models.EcapaConfig`
under the same keys (feat_dim, channels, stem_kernel, kernel, dilations,
scale, se_bottleneck, attention_bottleneck, mfa_channels, embed_dim,
num_speakers).  It extracts only: no ``train`` section, so this kind has
no training assembly.

- the program: the port's `EcapaTdnn`, built inside `build`, the one
  function here that imports the program;
- the weights' names and shapes, which start at 1 and which program
  buffers no configuration names (`reference.ecapa`);
- the plain reference: `embed`, a chunk's embedding (`reference.ecapa`);
- the count: `embed_flops`.
"""

from __future__ import annotations

from typing import Mapping

import torch

from reference.ecapa import PROGRAM_ONLY, embed, param_names, starts_at_one  # noqa: F401

KEYS = ("feat_dim", "channels", "stem_kernel", "kernel", "scale", "se_bottleneck",
        "attention_bottleneck", "mfa_channels", "embed_dim", "num_speakers")


def build(cfg: Mapping, device: torch.device, dtype: str = "float32") -> torch.nn.Module:
    """The port's model for the configuration, constructed on ``device``;
    it computes in float32 alone."""
    from sepi_tpu_torch import models as M

    if dtype != "float32":
        raise ValueError(f"ECAPA-TDNN extracts in float32, not {dtype}")
    with torch.device(device):
        mc = M.EcapaConfig(dilations=tuple(int(d) for d in cfg["dilations"]),
                           **{k: int(cfg[k]) for k in KEYS})
        return M.EcapaTdnn(mc)


def frame_flops(cfg: Mapping) -> float:
    """Forward flops a frame (2 per multiply-add): the stem, each block's
    two k = 1 convolutions and ``scale - 1`` dilated ones, the MFA, and the
    attention's two products (4608 -> 128 on [h; mu; sigma], 128 -> 1536)."""
    c, width, nb = cfg["channels"], cfg["channels"] // cfg["scale"], len(cfg["dilations"])
    m, a = cfg["mfa_channels"], cfg["attention_bottleneck"]
    stem = cfg["feat_dim"] * cfg["stem_kernel"] * c
    block = 2 * c * c + (cfg["scale"] - 1) * width * width * cfg["kernel"]
    return 2.0 * (stem + nb * block + nb * c * m + 3 * m * a + a * m)


def chunk_flops(cfg: Mapping) -> float:
    """Forward flops once a chunk: each block's SE bottleneck (two affines
    on the mean over time) and the head's affine to the embedding."""
    c, nb = cfg["channels"], len(cfg["dilations"])
    return 2.0 * (nb * 2 * c * cfg["se_bottleneck"] + 2 * cfg["mfa_channels"] * cfg["embed_dim"])


def embed_flops(cfg: Mapping, frames: int) -> float:
    return frames * frame_flops(cfg) + chunk_flops(cfg)
