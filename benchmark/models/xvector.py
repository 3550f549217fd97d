"""The v2 x-vector (Snyder et al., ICASSP 2018; `egs/sre/v2`
`run_xvector_new.sh:90-115`): a kind of model, found by a configuration's
``"model": "xvector"``.

Its configuration holds one frame-level stack, ``arch.frames`` (layers
as [dim, offsets]), then stats pooling and the segment head (tdnn6,
tdnn7, the output layer over ``num_speakers``).

- the program: the port's `XVector`, built inside `build`, the one
  function here that imports the program;
- the weights' names and shapes (`param_names`), which start at 1 and
  which program buffers no configuration names (`reference.tdnn`);
- the plain reference: `embed`, a chunk's embedding in eval mode, and
  `forward_train`, a batch's speaker logits in train mode (one task,
  ``xvec``, cross entropy in `reference.train.step`); both plain torch;
- the counts: `embed_flops`, `train_forward_flops`;
- the training assembly (`train_setup`), as
  `recipes/pipeline.train_xvector_model` assembles it: the held-out split
  and its sampler (seed + 1, two batches), the chunk sampler with blocks
  of K, the optimizer, the probe batch, the CE step.  Its calibration
  batches come after the whole budget, which no window reaches.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from harness import flops as F
from harness.training import Assembly, TrainInputs
from reference.tdnn import (PROGRAM_ONLY, head_embed, head_names, head_train, stack_eval,  # noqa: F401
                            stack_names, stack_train, starts_at_one)

TASKS = {"xvec": {}}  # task -> the model call's keyword arguments


def build(cfg: Mapping, device: torch.device, dtype: str = "float32") -> torch.nn.Module:
    """The port's model for the configuration, constructed on ``device``."""
    from sepi_tpu_torch import models as M

    from harness.port import tdnn_specs

    with torch.device(device):
        mc = M.XVectorConfig(feat_dim=cfg["feat_dim"], num_speakers=cfg["num_speakers"],
                             frame_specs=tdnn_specs(cfg["arch"]["frames"]["layers"]),
                             embed_dim=cfg["embed_dim"])
        return M.XVector(mc, dtype=dtype)


def param_names(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    pooled = 2 * stack_names(out, cfg["arch"]["frames"], cfg["feat_dim"])
    head_names(out, pooled, cfg)
    return out


def embed(feats: torch.Tensor, p, cfg: Mapping, prec: str = "ref") -> torch.Tensor:
    """embedding_a of one chunk (T, D)."""
    return head_embed(stack_eval(feats, p, cfg["arch"]["frames"], prec), p, prec)


def forward_train(feats: torch.Tensor, p, cfg: Mapping, task: str, prec: str) -> torch.Tensor:
    """Logits (B, speakers) of a training batch (B, T, D)."""
    if task != "xvec":
        raise ValueError(f"the x-vector trains no task {task!r}")
    return head_train(stack_train(feats, p, cfg["arch"]["frames"], prec), p, prec)


def _trunk(cfg: Mapping, frames: int):
    return F.stack_flops(cfg["arch"]["frames"]["layers"], cfg["feat_dim"], frames)


def embed_flops(cfg: Mapping, frames: int) -> float:
    f, _, dim = _trunk(cfg, frames)
    return f + F.embed_head_flops(dim, cfg)


def train_forward_flops(cfg: Mapping, task: str, batch: int, frames: int) -> float:
    f, _, dim = _trunk(cfg, frames)
    return batch * (f + F.train_head_flops(dim, cfg))


def train_setup(s: TrainInputs) -> Assembly:
    from sepi_tpu_torch.data.sampler import ChunkSampler
    from sepi_tpu_torch.recipes.pipeline import auto_heldout, heldout_split
    from sepi_tpu_torch.train import TrainState, build_optimizer, make_eval_step, make_xvec_step

    from harness import port

    tc, features, dataset = s.train_cfg, s.features, s.dataset
    label_map = dataset.speaker_label_map()
    train_ds, valid_batches, eval_steps = dataset, None, None
    held = auto_heldout(dataset, None)
    if held > 0:
        train_ds, valid_ds = heldout_split(dataset, held)
        valid_utts = [u for u in valid_ds.utt_ids if u in features]
        if not valid_utts:
            train_ds = dataset
        else:
            vs = ChunkSampler({u: features[u] for u in valid_utts}, dataset.subset(valid_utts),
                              tc.chunks, min(tc.batch_size, max(len(valid_utts), 2)), tc.seed + 1,
                              label_map=label_map)
            valid_batches = [vs.sample_batch(n) for n in vs.buckets[:2]]
            eval_steps = {"xvec": make_eval_step()}
    train_feats = {u: features[u] for u in train_ds.utt_ids if u in features}
    sampler = ChunkSampler(train_feats, dataset.subset(train_ds.utt_ids), tc.chunks, tc.batch_size,
                           tc.seed, block_size=tc.steps_per_dispatch, label_map=label_map)
    tx, _ = build_optimizer(tc.optimizer, s.num_steps)
    sampler.sample_batch(sampler.buckets[0])  # the reference's probe batch

    params = s.weights(param_names(s.cfg), 1)
    model = port.seeded_model(s.cfg, params, s.device, tc.compute_dtype, kind=s.kind)
    state = TrainState(model, tx.init(dict(model.named_parameters())), 0)
    return Assembly(tasks=TASKS, feed=sampler, train_ds=train_ds, train_feats=train_feats,
                    label_map=label_map, valid_batches=valid_batches, eval_steps=eval_steps,
                    tx=tx, lr_factors={}, state=state,
                    ref_init={n: params[n] for n, _ in model.named_parameters()},
                    steps={"xvec": make_xvec_step(tx, TASKS["xvec"])})
