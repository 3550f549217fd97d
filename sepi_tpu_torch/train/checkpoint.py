"""Checkpoints and checkpoint-tail combination.

Port of `sepi_tpu/train/checkpoint.py`: the reference's `{iter}.raw` model
files + `nnet3-combine`.  A checkpoint is one `torch.save` file,
``ckpt_{step}.pt``, holding the model's state_dict, the optimizer state
and the step; every ``keep_every``-th is preserved
(`--cleanup.preserve-model-interval`) besides the newest ``max_keep``.
The final model may be the best prefix average over the checkpoint tail
on a held-out objective, freshest first so the newest batch-norm
statistics win (`frame_level_objf/common.py:864-1055`).
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from .trainer import TrainState


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def save_checkpoint(state: TrainState, directory: str, step: int, keep_every: int = 10,
                    max_keep: int = 25) -> str:
    """Write ``ckpt_{step}.pt``; prune old ones except every
    ``keep_every``-th (remove_model semantics, train_cvector_dnn.py:327-333)."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    payload = {"model": _to_cpu(state.model.state_dict()),
               "opt_state": _to_cpu(state.opt_state), "step": state.step}
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    steps = sorted(_list_steps(directory))
    recent = set(steps[-max_keep:])
    for s in steps:
        if s not in recent and (keep_every == 0 or s % keep_every != 0):
            os.remove(_path(directory, s))
    return path


def _list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return [int(m.group(1)) for name in os.listdir(directory)
            if (m := re.fullmatch(r"ckpt_(\d+)\.pt", name))]


def latest_checkpoint(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return max(steps) if steps else None


def _read(directory: str, step: int) -> dict:
    # checkpoints hold only tensors, dicts and ints written by save_checkpoint
    return torch.load(_path(directory, step), map_location="cpu", weights_only=True)


def _moved(x, like):
    if isinstance(x, torch.Tensor):
        return x.to(like.device) if isinstance(like, torch.Tensor) else x
    if isinstance(x, dict):
        return {k: _moved(v, like.get(k) if isinstance(like, dict) else None)
                for k, v in x.items()}
    return x


def _restore(template: TrainState, payload: dict) -> TrainState:
    state = template.clone()
    state.model.load_state_dict(payload["model"])
    state.opt_state = _moved(payload["opt_state"], template.opt_state)
    state.step = int(payload["step"])
    return state


def load_checkpoint(template: TrainState, directory: str, step: Optional[int] = None) -> TrainState:
    """A new TrainState like ``template`` (same devices) restored from a
    checkpoint; the newest when ``step`` is None."""
    if step is None:
        step = latest_checkpoint(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return _restore(template, _read(directory, step))


def combine_checkpoints(template: TrainState, directory: str, objf_fn: Callable,
                        num_tail: int = 10):
    """nnet3-combine analog: among uniform averages of the last K
    checkpoints (K = 1..num_tail, freshest first), the one with the best
    ``objf_fn(state)``.  Only parameters are averaged; batch-norm
    statistics, the optimizer state and the step are the freshest
    checkpoint's.  Returns (state, objf)."""
    steps = sorted(_list_steps(directory))[-num_tail:]
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    payloads = [_read(directory, s) for s in reversed(steps)]
    names = [n for n, _ in template.model.named_parameters()]
    best_state = _restore(template, payloads[0])
    best_objf = objf_fn(best_state)
    avg = {n: payloads[0]["model"][n] for n in names}
    for k in range(1, len(payloads)):
        avg = {n: (avg[n] * k + payloads[k]["model"][n]) / (k + 1) for n in names}
        cand = _restore(template, {**payloads[0], "model": {**payloads[0]["model"], **avg}})
        objf = objf_fn(cand)
        if objf > best_objf:
            best_state, best_objf = cand, objf
    return best_state, best_objf


def parameter_progress(old_params: Mapping[str, torch.Tensor],
                       new_params: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """nnet3-show-progress analog: ||new - old|| / ||old|| per top-level
    component (``frames``, ``segment``), over parameters (named_parameters
    keys, e.g. host copies taken at checkpoint boundaries), in float64."""
    sq_o: Dict[str, float] = {}
    sq_d: Dict[str, float] = {}
    for name, o in old_params.items():
        top = name.split(".")[0]
        o64 = np.asarray(torch.as_tensor(o).detach().cpu(), np.float64)
        n64 = np.asarray(torch.as_tensor(new_params[name]).detach().cpu(), np.float64)
        sq_o[top] = sq_o.get(top, 0.0) + float(np.sum(np.square(o64)))
        sq_d[top] = sq_d.get(top, 0.0) + float(np.sum(np.square(n64 - o64)))
    return {k: float(np.sqrt(sq_d[k]) / max(np.sqrt(sq_o[k]), 1e-20)) for k in sq_o}
