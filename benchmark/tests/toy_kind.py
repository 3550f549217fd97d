"""A model kind the benchmark does not know, as a later change would add
one: copied by the tests into ``models/tdnn_flat.py`` of a temporary root
beside a configuration with ``"model": "tdnn_flat"``.

A flat TDNN: the configuration lists its frame layers under ``layers``
(no ``arch``); the program is the port's `XVector`; training is one
``xvec`` task on a chunk sampler with no held-out split and no probe
batch.  It uses only what `reference.tdnn` and `harness` offer every kind.
"""

from __future__ import annotations

import torch

from harness import flops as F
from harness.training import Assembly
from reference.tdnn import (PROGRAM_ONLY, head_embed, head_names, head_train, stack_eval,  # noqa: F401
                            stack_names, stack_train, starts_at_one)

TASKS = {"xvec": {}}


def _stack(cfg):
    return {"prefix": "frames", "layers": cfg["layers"]}


def build(cfg, device, dtype="float32"):
    from sepi_tpu_torch.models import XVector, XVectorConfig

    from harness.port import tdnn_specs

    with torch.device(device):
        return XVector(XVectorConfig(feat_dim=cfg["feat_dim"], num_speakers=cfg["num_speakers"],
                                     frame_specs=tdnn_specs(cfg["layers"]),
                                     embed_dim=cfg["embed_dim"]), dtype=dtype)


def param_names(cfg):
    out = {}
    head_names(out, 2 * stack_names(out, _stack(cfg), cfg["feat_dim"]), cfg)
    return out


def embed(feats, p, cfg, prec="ref"):
    return head_embed(stack_eval(feats, p, _stack(cfg), prec), p, prec)


def forward_train(feats, p, cfg, task, prec):
    return head_train(stack_train(feats, p, _stack(cfg), prec), p, prec)


def embed_flops(cfg, frames):
    f, _, dim = F.stack_flops(cfg["layers"], cfg["feat_dim"], frames)
    return f + F.embed_head_flops(dim, cfg)


def train_forward_flops(cfg, task, batch, frames):
    f, _, dim = F.stack_flops(cfg["layers"], cfg["feat_dim"], frames)
    return batch * (f + F.train_head_flops(dim, cfg))


def train_setup(s):
    from sepi_tpu_torch.data.sampler import ChunkSampler
    from sepi_tpu_torch.train import TrainState, build_optimizer, make_xvec_step

    from harness import port

    tc = s.train_cfg
    label_map = s.dataset.speaker_label_map()
    sampler = ChunkSampler(s.features, s.dataset, tc.chunks, tc.batch_size, tc.seed,
                           block_size=tc.steps_per_dispatch, label_map=label_map)
    tx, _ = build_optimizer(tc.optimizer, s.num_steps)
    params = s.weights(param_names(s.cfg), 1)
    model = port.seeded_model(s.cfg, params, s.device, tc.compute_dtype, kind=s.kind)
    state = TrainState(model, tx.init(dict(model.named_parameters())), 0)
    return Assembly(tasks=TASKS, feed=sampler, train_ds=s.dataset, train_feats=s.features,
                    label_map=label_map, valid_batches=None, eval_steps=None, tx=tx,
                    lr_factors={}, state=state,
                    ref_init={n: params[n] for n, _ in model.named_parameters()},
                    steps={"xvec": make_xvec_step(tx, {})})
