"""Parameter grafting: load a pretrained subtree into a fresh model.

Port of `sepi_tpu/train/graft.py`.  The reference's model surgery for
v4/v5 (`train_xvector_with_am.sh:59-65`: `nnet3-init --existing-model
am/final.raw`, then `nnet3-copy --edits=set-learning-rate-factor`) is a
copy of the pretrained AM's tensors into the target's ``am`` submodule;
the learning-rate factor is the optimizer's (`optim.subtree_lr_factors`).
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn


def graft_subtree(target: nn.Module, source: Union[nn.Module, Mapping[str, torch.Tensor]],
                  subtree: str) -> nn.Module:
    """Copy ``source``'s parameters and batch-norm buffers into
    ``target``'s ``subtree`` submodule, in place, and return ``target``.

    ``source`` is a module or a state_dict holding the subtree's contents
    at top level (a standalone `AmNet`) or under ``subtree``.  Shapes are
    checked entry by entry (a mismatch means the architectures diverged,
    the error nnet3-init raises); source entries the target lacks (the
    AM's ``output`` head) are dropped.  The values are copied into the
    target's own tensors, so training the target leaves the source as it was.
    """
    src = source.state_dict() if isinstance(source, nn.Module) else dict(source)
    head = subtree + "."
    if any(k.startswith(head) for k in src):
        src = {k[len(head):]: v for k, v in src.items() if k.startswith(head)}
    tgt = {k[len(head):]: v for k, v in target.state_dict().items() if k.startswith(head)}
    if not tgt:
        raise ValueError(f"graft: the target has no submodule {subtree!r}")
    missing = sorted(set(tgt) - set(src))
    if missing:
        raise ValueError(f"graft: source missing {missing[:5]} under {subtree}")
    for k, t in tgt.items():
        if tuple(t.shape) != tuple(src[k].shape):
            raise ValueError(f"graft: shape mismatch at {subtree}.{k}: target "
                             f"{tuple(t.shape)} vs source {tuple(src[k].shape)}")
    with torch.no_grad():
        for k, t in tgt.items():
            t.copy_(src[k])
    return target
