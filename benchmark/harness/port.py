"""The program under test, built from a configuration file.

This is the one module of the harness that imports the program
(`sepi_tpu_torch`, the PyTorch and CUDA port), and it does so inside its
functions.  It maps a configuration's keys onto the port's config
classes and constructs its model on the device, then puts the
benchmark's weights into it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

from . import weights as W


def frontend_configs(cfg: Mapping):
    """(FrontendConfig, VadConfig, CmvnConfig) from the configuration."""
    from sepi_tpu_torch.config import CmvnConfig, FrontendConfig, VadConfig

    def build(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    return build(FrontendConfig, cfg["frontend"]), build(VadConfig, cfg["vad"]), \
        build(CmvnConfig, cfg["cmvn"])


def extract_config(cfg: Mapping):
    from sepi_tpu_torch.config import ExtractConfig

    e = cfg["extract"]
    return ExtractConfig(min_chunk_size=e["min_chunk_size"], chunk_size=e["chunk_size"],
                         embedding_node=e["embedding_node"], batch_size=e["batch_size"])


def _tdnn_specs(layers):
    from sepi_tpu_torch.models import TdnnSpec

    return tuple(TdnnSpec(int(d), tuple(int(o) for o in offs)) for d, offs in layers)


def build_model(cfg: Mapping, device: torch.device, dtype: str = "float32") -> torch.nn.Module:
    """The port's model for the configuration, constructed on ``device``."""
    from sepi_tpu_torch import models as M

    with torch.device(device):
        if cfg["model"] == "xvector":
            mc = M.XVectorConfig(feat_dim=cfg["feat_dim"], num_speakers=cfg["num_speakers"],
                                 frame_specs=_tdnn_specs(cfg["arch"]["frames"]["layers"]),
                                 embed_dim=cfg["embed_dim"])
            return M.XVector(mc, dtype=dtype)
        if cfg["model"] == "combined":
            return M.CombinedCVector(combined_config(cfg), dtype=dtype)
    raise ValueError(f"unknown model {cfg['model']!r}")


def am_config(cfg: Mapping):
    """The pretrained AM feed's `AmConfig` of a combined model."""
    from sepi_tpu_torch.models import AmConfig

    return AmConfig(feat_dim=cfg["feat_dim"], num_senones=cfg["num_senones"],
                    specs=_tdnn_specs(cfg["arch"]["am"]["layers"]))


def combined_config(cfg: Mapping):
    from sepi_tpu_torch.models import CombinedConfig

    return CombinedConfig(feat_dim=cfg["feat_dim"], num_speakers=cfg["num_speakers"],
                          num_senones=cfg["num_senones"], am=am_config(cfg),
                          num_shared=cfg["num_shared"], embed_dim=cfg["embed_dim"],
                          hidden_dim=cfg["hidden_dim"], pool_dim=cfg["pool_dim"])


def am_context(cfg: Mapping):
    """The am task's frame-egs context, as the trainers take it."""
    return combined_config(cfg).am_context


def model_kwargs(cfg: Mapping) -> Dict:
    task = cfg["extract"].get("task")
    return {"task": task} if task else {}


def seeded_model(cfg: Mapping, params: Mapping[str, torch.Tensor], device: torch.device,
                 dtype: str = "float32") -> torch.nn.Module:
    model = build_model(cfg, device, dtype)
    W.load_into(model, params)
    return model
