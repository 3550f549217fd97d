"""Entry point: the flagship model's embedding forward with example inputs.

Port of `__graft_entry__.entry`.  ``entry(device)`` returns ``(forward,
(model, feats))``: the full-size v2 x-vector (`V2_XVECTOR` with 5000
speakers) with Flax-style initial weights from seed 0
(`models.lecun_normal_init`; the draws are not Flax's), in eval mode on
``device``; ``forward(model, feats)`` gives the ``embedding_a`` of (8,
300, 23) float32 features drawn from ``numpy.random.default_rng(0)``, the
reference's own example batch.  The reference's multi-device dry run is
`parallel.dryrun.dryrun_multichip`.

    forward, args = entry()          # device="cuda"
    emb = forward(*args)             # (8, 512)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import DeviceLike, fp32_math, resolve_device

NUM_SPEAKERS = 5000
FEATS_SHAPE = (8, 300, 23)


@fp32_math()
def _forward(model: torch.nn.Module, feats: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return model(feats)["embedding_a"]


def entry(device: DeviceLike = "cuda"):
    from .models import V2_XVECTOR, XVector, lecun_normal_init

    dev = resolve_device(device)
    model = XVector(dataclasses.replace(V2_XVECTOR, num_speakers=NUM_SPEAKERS))
    lecun_normal_init(model, 0)
    model = model.to(dev).eval()
    feats = torch.from_numpy(
        np.random.default_rng(0).normal(size=FEATS_SHAPE).astype(np.float32)).to(dev)
    return _forward, (model, feats)
