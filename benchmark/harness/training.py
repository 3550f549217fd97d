"""What the training driver hands a model kind's ``train_setup``, and
what it hands back: the recipe's assembly of one kind of model, which the
driver then runs, times and checks the same way for every kind."""

from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Any, Callable, Dict, Iterable, Mapping, Optional


@dataclasses.dataclass
class TrainInputs:
    """The configuration, the `TrainConfig` made from its ``train``
    section, the seeded data in host memory, the step budget and the
    device."""

    kind: ModuleType
    cfg: Mapping
    train_cfg: Any
    features: Dict
    alignments: Dict
    dataset: Any
    num_steps: int
    device: Any
    weights: Callable[[Mapping, int], Dict]  # (shapes, tag) -> seeded tensors on the device


@dataclasses.dataclass
class Assembly:
    """One kind's training as its recipe assembles it."""

    tasks: Dict[str, Dict]  # task -> the model call's keyword arguments
    feed: Iterable  # the recipe's batch stream
    train_ds: Any  # the training split, its features and labels: the
    train_feats: Dict  # driver's own sampler of every chunk bucket
    label_map: Dict
    valid_batches: Optional[list]
    eval_steps: Optional[Dict[str, Callable]]
    tx: Any  # the optimizer chain
    lr_factors: Dict[str, float]  # per-subtree learning-rate factors (the reference's too)
    state: Any  # the TrainState, with the seeded weights
    ref_init: Dict  # parameter name -> the weights the reference starts from
    steps: Dict[str, Callable]  # task -> the CE step
