"""What the extraction and verification drivers share: the program's
configs and seeded model for an embedding configuration (its weights
named by the configuration's model kind), and the warm-up of every
bucket of the extraction ladder."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from . import audio, port
from . import weights as W


@dataclasses.dataclass
class Embedder:
    """The program's frontend and extraction configs and its model with
    the benchmark's weights (``params``, which the reference reads too)."""

    fcfg: object
    vcfg: object
    ccfg: object
    ecfg: object
    min_frames: int
    kwargs: Dict
    params: Dict[str, torch.Tensor]
    model: torch.nn.Module


def embedder(ctx) -> Embedder:
    cfg, dev, kind = ctx.cell.config, ctx.device, ctx.cell.model
    params = W.make(kind.param_names(cfg), ctx.sub_seed(1), dev, kind)
    return Embedder(*port.frontend_configs(cfg), port.extract_config(cfg),
                    cfg["extract"]["min_frames"], port.model_kwargs(cfg), params,
                    port.seeded_model(cfg, params, dev, kind=kind).eval())


def warm_buckets(ctx, emb: Embedder, extract: Callable[[Dict], Dict]) -> None:
    """``extract`` over one chunk of seeded features of every bucket length."""
    from sepi_tpu_torch.extract import bucket_ladder

    g = audio.generator(ctx.sub_seed(4), ctx.device)
    feats = {f"warm{b}": torch.randn((b, ctx.cell.config["feat_dim"]), generator=g,
                                     device=ctx.device).cpu().numpy()
             for b in bucket_ladder(emb.ecfg, emb.min_frames)}
    extract(feats)
