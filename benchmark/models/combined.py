"""The v5 combined c-vector (Liu et al., Interspeech 2018; `egs/sre/v5`
`prepare_nnet3_xconfig.sh:46-91`, `train_cvector_with_am.sh:65-89`): a
kind of model, found by a configuration's ``"model": "combined"``.

Its configuration holds the shared trunk (``arch.shared``), the multitask
AM head (``arch.am_branch``, then ``output_am`` over ``num_senones``),
the x-vector branch (``arch.xvec_branch``), the pretrained AM feed
(``arch.am``) appended to it ahead of ``tdnn5`` (``pool_dim``), then stats
pooling and the segment head.

- the program: the port's `CombinedCVector`, built inside `build`, and
  the `AmNet` its ``am`` subtree is grafted from, inside `train_setup`;
  these two import the program;
- the weights' names and shapes (`param_names`), which start at 1 and
  which program buffers no configuration names (`reference.tdnn`);
- the plain reference: `embed` (eval mode, one chunk) and
  `forward_train` (train mode: the ``am`` task's per-frame senone
  logits, the ``xvec`` task's speaker logits; cross entropy in
  `reference.train.step`); both plain torch;
- the counts: `embed_flops`, `train_forward_flops` per task;
- the training assembly (`train_setup`), as
  `recipes/phonetic._two_task_run` assembles it: the held-out split and
  batches (`phonetic._heldout_valid`), the two samplers and their
  `MultitaskInterleaver` (`phonetic._multitask_iter`), `build_optimizer`
  with the ``am`` learning-rate factor, the probe batch, the ``am``
  subtree grafted from a seeded `AmNet`, the two CE steps and the
  calibration draws, in the recipe's order of draws.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from harness import flops as F
from harness.training import Assembly, TrainInputs
from reference.tdnn import (PROGRAM_ONLY, append, context, head_embed, head_names,  # noqa: F401
                            head_train, layer_eval, layer_names, layer_train, linear,
                            stack_eval, stack_names, stack_train, stacks_context, starts_at_one)

TASKS = {"am": {"task": "am"}, "xvec": {"task": "xvec"}}  # task -> the model call's kwargs


def am_config(cfg: Mapping):
    """The pretrained AM feed's `AmConfig`."""
    from sepi_tpu_torch.models import AmConfig

    from harness.port import tdnn_specs

    return AmConfig(feat_dim=cfg["feat_dim"], num_senones=cfg["num_senones"],
                    specs=tdnn_specs(cfg["arch"]["am"]["layers"]))


def combined_config(cfg: Mapping):
    from sepi_tpu_torch.models import CombinedConfig

    return CombinedConfig(feat_dim=cfg["feat_dim"], num_speakers=cfg["num_speakers"],
                          num_senones=cfg["num_senones"], am=am_config(cfg),
                          num_shared=cfg["num_shared"], embed_dim=cfg["embed_dim"],
                          hidden_dim=cfg["hidden_dim"], pool_dim=cfg["pool_dim"])


def build(cfg: Mapping, device: torch.device, dtype: str = "float32") -> torch.nn.Module:
    """The port's model for the configuration, constructed on ``device``."""
    from sepi_tpu_torch import models as M

    with torch.device(device):
        return M.CombinedCVector(combined_config(cfg), dtype=dtype)


def param_names(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    arch = cfg["arch"]
    out: Dict[str, Tuple[int, ...]] = {}
    d = cfg["feat_dim"]
    s = stack_names(out, arch["shared"], d)
    a = stack_names(out, arch["am_branch"], s)
    out["output_am.weight"] = (cfg["num_senones"], a)
    out["output_am.bias"] = (cfg["num_senones"],)
    x = stack_names(out, arch["xvec_branch"], s)
    b = stack_names(out, arch["am"], d)
    layer_names(out, "tdnn5", x + b, cfg["pool_dim"], 1)
    head_names(out, 2 * cfg["pool_dim"], cfg)
    return out


def _merged(xv, am, arch):
    return append([(xv, stacks_context(arch, "shared", "xvec_branch")),
                   (am, stacks_context(arch, "am"))])


def embed(feats: torch.Tensor, p, cfg: Mapping, prec: str = "ref") -> torch.Tensor:
    """embedding_a of one chunk (T, D)."""
    arch = cfg["arch"]
    shared = stack_eval(feats, p, arch["shared"], prec)
    xv = stack_eval(shared, p, arch["xvec_branch"], prec)
    am = stack_eval(feats, p, arch["am"], prec)
    h, _ = layer_eval(_merged(xv, am, arch), p, "tdnn5", [0], prec)
    return head_embed(h, p, prec)


def forward_train(feats: torch.Tensor, p, cfg: Mapping, task: str, prec: str) -> torch.Tensor:
    """Logits of a training batch: (B, L, senones) for the am task,
    (B, speakers) for the xvec task."""
    arch = cfg["arch"]
    shared = stack_train(feats, p, arch["shared"], prec)
    if task == "am":
        h = stack_train(shared, p, arch["am_branch"], prec)
        return linear(h, p, "output_am")
    xv = stack_train(shared, p, arch["xvec_branch"], prec)
    am = stack_train(feats, p, arch["am"], prec)
    h = layer_train(_merged(xv, am, arch), p, "tdnn5", [0], prec)
    return head_train(h, p, prec)


def _trunk(cfg: Mapping, frames: int):
    """The frame-level layers up to stats pooling: (flops, frames, dim)."""
    arch, d = cfg["arch"], cfg["feat_dim"]
    f_sh, t_sh, d_sh = F.stack_flops(arch["shared"]["layers"], d, frames)
    f_xv, _, d_xv = F.stack_flops(arch["xvec_branch"]["layers"], d_sh, t_sh)
    f_am, _, d_am = F.stack_flops(arch["am"]["layers"], d, frames)
    xl, xr = context(arch["shared"]["layers"] + arch["xvec_branch"]["layers"])
    al, ar = context(arch["am"]["layers"])
    merged = frames - max(xl, al) - max(xr, ar)
    f5 = 2.0 * max(merged, 0) * (d_xv + d_am) * cfg["pool_dim"]
    return f_sh + f_xv + f_am + f5, merged, cfg["pool_dim"]


def embed_flops(cfg: Mapping, frames: int) -> float:
    f, _, dim = _trunk(cfg, frames)
    return f + F.embed_head_flops(dim, cfg)


def train_forward_flops(cfg: Mapping, task: str, batch: int, frames: int) -> float:
    arch, d = cfg["arch"], cfg["feat_dim"]
    if task == "am":
        f_sh, t_sh, d_sh = F.stack_flops(arch["shared"]["layers"], d, frames)
        f_am, t_am, d_am = F.stack_flops(arch["am_branch"]["layers"], d_sh, t_sh)
        return batch * (f_sh + f_am + 2.0 * t_am * d_am * cfg["num_senones"])
    f, _, dim = _trunk(cfg, frames)
    return batch * (f + F.train_head_flops(dim, cfg))


def train_setup(s: TrainInputs) -> Assembly:
    from sepi_tpu_torch.models import AmNet
    from sepi_tpu_torch.recipes import phonetic
    from sepi_tpu_torch.train import (TrainState, build_optimizer, graft_subtree, make_am_step,
                                      make_eval_step, make_xvec_step)

    from harness import port
    from harness import weights as W

    cfg, tc, train_cfg = s.cfg, s.cfg["train"], s.train_cfg
    am_context = combined_config(cfg).am_context
    label_map = s.dataset.speaker_label_map()
    train_ds, feats_tr, ali_tr, valid_batches = phonetic._heldout_valid(
        s.features, s.alignments, s.dataset, train_cfg, None, am_context, tc["frames_per_eg"])
    _, xvec_sampler, interleaver = phonetic._multitask_iter(
        feats_tr, ali_tr, train_ds, train_cfg, am_context, s.num_steps, tc["frames_per_eg"],
        label_map=label_map)
    lr_factors = {"am": tc["am_lr_factor"]}
    tx, _ = build_optimizer(train_cfg.optimizer, s.num_steps, lr_factors=lr_factors)
    xvec_sampler.sample_batch(xvec_sampler.buckets[0])  # the reference's probe batch

    # the model: seeded weights on the device, the am subtree grafted
    shapes = param_names(cfg)
    params = s.weights(shapes, 1)
    am_params = s.weights({n[len("am."):]: v for n, v in shapes.items() if n.startswith("am.")}, 8)
    model = port.seeded_model(cfg, params, s.device, train_cfg.compute_dtype, kind=s.kind)
    with torch.device(s.device):
        am_net = AmNet(am_config(cfg), with_logits=False, dtype=train_cfg.compute_dtype)
    W.load_into(am_net, am_params, s.kind)
    state = TrainState(model, tx.init(dict(model.named_parameters())), 0)
    graft_subtree(state.model, am_net, "am")
    del am_net
    ref_init = {n: (am_params[n[len("am."):]] if n.startswith("am.") else params[n])
                for n, _ in model.named_parameters()}
    steps = {t: (make_am_step if t == "am" else make_xvec_step)(tx, kw)
             for t, kw in TASKS.items()}
    [xvec_sampler.sample_batch(b).feats for b in xvec_sampler.buckets[:3]]  # calibration draws
    eval_steps = ({t: make_eval_step(kw) for t, kw in TASKS.items()}
                  if valid_batches else None)
    return Assembly(tasks=TASKS, feed=iter(interleaver), train_ds=train_ds, train_feats=feats_tr,
                    label_map=label_map, valid_batches=valid_batches, eval_steps=eval_steps,
                    tx=tx, lr_factors=lr_factors, state=state, ref_init=ref_init, steps=steps)
