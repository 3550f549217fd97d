"""The program under test, built from a configuration file.

With the model kinds (`benchmark/models/<model>.py`, each of which builds
its own program model) and the drivers, this is where the harness
imports the program (`sepi_tpu_torch`, the PyTorch and CUDA port), and it
does so inside its functions.  It maps a configuration's frontend and
extraction keys onto the port's config classes, has the configuration's
model kind construct its model on the device, then puts the benchmark's
weights into it.
"""

from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Dict, Mapping, Optional

import torch

from . import weights as W
from .core import model_kind


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


def tdnn_specs(layers):
    """The port's `TdnnSpec`s of a stack's [dim, offsets] layers."""
    from sepi_tpu_torch.models import TdnnSpec

    return tuple(TdnnSpec(int(d), tuple(int(o) for o in offs)) for d, offs in layers)


def build_model(cfg: Mapping, device: torch.device, dtype: str = "float32",
                kind: Optional[ModuleType] = None) -> torch.nn.Module:
    """The port's model for the configuration, constructed on ``device``
    by its model kind (``kind``, by default found by the configuration's
    ``model`` key)."""
    return (kind or model_kind(cfg)).build(cfg, device, dtype)


def model_kwargs(cfg: Mapping) -> Dict:
    task = cfg["extract"].get("task")
    return {"task": task} if task else {}


def seeded_model(cfg: Mapping, params: Mapping[str, torch.Tensor], device: torch.device,
                 dtype: str = "float32", kind: Optional[ModuleType] = None) -> torch.nn.Module:
    kind = kind or model_kind(cfg)
    model = build_model(cfg, device, dtype, kind)
    W.load_into(model, params, kind)
    return model
