"""Training loop: the cross-entropy step, supersteps, and the outer loop.

Port of `sepi_tpu/train/trainer.py`: speaker-chunk (x-vector), per-frame
senone (AM) and interleaved multitask steps.  What it keeps of the
reference:
- the objective: per-example mean log-prob (``objf``), ``accuracy`` and
  the global norm of the gradient (``grad_norm``), each step;
- a superstep: K steps back to back on the device from one stacked
  (K, B, L, D) batch, with the (K,) metric vectors returned; the same
  update sequence as K single steps;
- held-out diagnostics every ``eval_every`` steps, the divergence guard,
  and global step numbers across segmented ``run()`` calls.

A step leaves its metrics on the device; the host reads them only where
it logs or evaluates, so the card is not stalled once a step.  Input
batches are staged ahead of use from pinned host memory on a side stream.

On a CUDA state without a mesh the step factories return captured steps
(`train.graphs`), the counterpart of the reference's jit: a step is one
CUDA graph replay, a K-step superstep one replay of its K steps unrolled,
with the eager step's numbers; the held-out eval step is one replay of
an inference graph (`graphs.CallGraphs`).  ``capture=False`` runs
eagerly (the counterpart of `jax.disable_jit`); the CPU and a mesh run
eagerly.

With a ``mesh`` (`parallel.make_mesh`) a step is one step on the global
batch, as the reference's GSPMD step is: each rank takes its shard of the
batch, its batch norms average their moments over the mesh's data axis
(`models.tdnn.sync_batch_norm`), it backpropagates its local mean loss,
and the gradients are averaged over the data axis before the optimizer,
so clipping, Newton-Schulz and every update see the same reduced gradient
on every rank.  The reported objf and accuracy are reduced too, so every
host decision (the divergence guard, held-out evaluation, checkpoint-tail
combination) is the same on every rank.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.tdnn import batch_moments, lecun_normal_init, sync_batch_norm
from ..parallel.mesh import (batch_sharded, broadcast_state, data_group, local_shard,
                             reduce_sum_, superbatch_sharded)
from ..graphs import CallGraphs
from ..utils.logging import span
from .graphs import StepGraphs, eager_superstep
from .graphs import state_tensors as _state_tensors
from .optim import OptimizerChain, apply_updates, global_norm


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and batch-norm statistics), the optimizer
    chain's state and the number of steps taken."""

    model: torch.nn.Module
    opt_state: dict
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def clone(self) -> "TrainState":
        return TrainState(copy.deepcopy(self.model), copy.deepcopy(self.opt_state), self.step)


def init_weights(model: torch.nn.Module, seed: int) -> None:
    """The initial weights of a training run (Flax's initialisation)."""
    lecun_normal_init(model, seed)


def create_train_state(model: torch.nn.Module, tx: OptimizerChain, seed: int,
                       device: torch.device, mesh=None) -> TrainState:
    """Initialise ``model`` from ``seed``, move it to ``device`` and make
    the optimizer state.  (The reference also takes a sample batch to
    trace the model; torch needs none.)  With a ``mesh``, every rank of it
    then takes the mesh's first rank's parameters, buffers and optimizer
    state, as DDP does, so ranks start equal whatever seed each was given."""
    init_weights(model, seed)
    state = TrainState(model.to(device), {}, 0)
    state.opt_state = tx.init(state.params())
    if mesh is not None:
        broadcast_state(_state_tensors(state), mesh)
    return state


def _softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def _logits(out):
    return out["logits"] if "logits" in out else out["am_logits"]


def _reduced_bn(model: torch.nn.Module, group):
    return contextlib.nullcontext() if group is None else sync_batch_norm(model, group)


def _ce_step(tx: OptimizerChain, kw: Dict, group):
    """The CE step on this rank's batch; with a process ``group`` the
    batch norms, gradients and metrics are reduced over it.  ``scalars``
    is the chain's device row of per-step scalars in a captured step."""
    zeros: Dict[str, torch.Tensor] = {}

    def zero_like(name: str, p: torch.Tensor) -> torch.Tensor:
        if name not in zeros:
            zeros[name] = torch.zeros_like(p)
        return zeros[name]

    def step(state: TrainState, feats, labels, weight=1.0, scalars=None):
        model = state.model
        model.train()
        params = state.params()
        with _reduced_bn(model, group):
            logits = _logits(model(feats, **kw))
            xent = _softmax_xent(logits, labels)
            loss = weight * xent.mean()
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: zero_like(n, p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        with torch.no_grad():
            objf_acc = torch.stack([-xent.mean(), (logits.argmax(-1) == labels).float().mean()])
            if group is not None:
                # the gradient of the global mean loss: equal shards, so the
                # mean of the ranks' local-mean gradients
                reduce_sum_(grads.values(), group, mean=True)
                reduce_sum_([objf_acc], group, mean=True)
            metrics = {"objf": objf_acc[0], "accuracy": objf_acc[1],
                       "grad_norm": global_norm(grads.values())}
        apply_updates(params, tx.update(grads, state.opt_state, params, scalars))
        state.step += 1
        return metrics

    return step


def _captures(capture: Optional[bool], mesh) -> bool:
    """Whether a factory's step may capture: ``capture=None`` captures on
    a CUDA state and runs eagerly on the CPU; a mesh runs eagerly."""
    if mesh is not None:
        if capture:
            raise ValueError("capture=True with a mesh: a mesh step runs eagerly "
                             "(capture=None or False)")
        return False
    return capture is not False


def make_xvec_step(tx: OptimizerChain, task_kwargs: Optional[Dict] = None, mesh=None,
                   capture: Optional[bool] = None):
    """The CE train step: ``step(state, feats, labels, weight)`` updates
    ``state`` in place and returns {objf, accuracy, grad_norm} as device
    scalars.  Labels are (B,) for speaker chunks or (B, L) for per-frame
    targets; ``weight`` scales the loss (multitask weighting).

    A parameter the task's forward does not reach (the other head of a
    multitask model) gets a zero gradient, as `jax.grad` gives it, so the
    chain still moves it (momentum, shrink).  The zero tensors are made
    once per step function and shared by its steps.

    ``capture`` (the counterpart of `jax.disable_jit`): None replays a
    CUDA graph of the step on a CUDA state (`train.graphs`: one capture per
    batch shape and state identity) and runs eagerly on the CPU; False
    always runs eagerly; True raises on a CPU state or with a mesh.

    With a ``mesh``, ``feats`` and ``labels`` are the global batch: a
    DTensor (`parallel.assemble_global_batch`, what `Trainer(mesh=...)`
    stages) whose local shard this rank takes, or a tensor every rank
    holds, of which this rank takes its data-axis rows; a batch the data
    axis does not divide raises.  A mesh step runs eagerly."""
    kw = dict(task_kwargs or {})
    body = _ce_step(tx, kw, data_group(mesh))
    if _captures(capture, mesh):
        return StepGraphs(body, tx, kw, body, capture=capture)
    if mesh is None:
        return body

    def step(state: TrainState, feats, labels, weight=1.0):
        return body(state, local_shard(feats, mesh), local_shard(labels, mesh), weight)

    return step


def make_am_step(tx: OptimizerChain, task_kwargs: Optional[Dict] = None, mesh=None,
                 capture: Optional[bool] = None):
    """The per-frame senone CE step: labels (B, L) aligned with the
    logits' frames (the sampler cuts the model's context margin around
    them), against ``logits`` or, in a multitask model, ``am_logits``.
    The same step as `make_xvec_step`, as in the reference."""
    return make_xvec_step(tx, task_kwargs, mesh, capture)


def make_superstep(tx: OptimizerChain, task_kwargs: Optional[Dict] = None, mesh=None,
                   capture: Optional[bool] = None):
    """K train steps back to back: ``sstep(state, feats (K, B, ...),
    labels (K, B, ...), weights (K,))`` runs the CE step on each slice in
    order and returns each metric stacked to (K,).  On a CUDA state
    (``capture`` as in `make_xvec_step`) the K steps are one graph replay,
    as the reference's `lax.scan` is one dispatch.  With a ``mesh`` the
    batch axis (dim 1) is sharded over the data axis, eagerly."""
    kw = dict(task_kwargs or {})
    body = _ce_step(tx, kw, data_group(mesh))
    eager = eager_superstep(body)
    if _captures(capture, mesh):
        return StepGraphs(body, tx, kw, eager, superstep=True, capture=capture)
    if mesh is None:
        return eager

    def sstep(state: TrainState, feats, labels, weights):
        return eager(state, local_shard(feats, mesh, 1), local_shard(labels, mesh, 1), weights)

    return sstep


def make_eval_step(task_kwargs: Optional[Dict] = None, mesh=None, frame_level: bool = False,
                   capture: Optional[bool] = None):
    """Held-out objective: ``ev(state, feats, labels)`` -> {objf,
    accuracy} as device scalars, in eval mode (running statistics).
    Labels are (B,) speaker labels or (B, L) frame labels, whatever
    ``frame_level`` says (the reference's keyword, which its step does not
    read either).  With a
    ``mesh`` every rank scores the whole batch and the values are averaged
    over the data axis, so every rank reads the same numbers.

    ``capture`` as in `make_xvec_step`: None replays a CUDA graph of the
    evaluation on a CUDA state without a mesh (`graphs.CallGraphs`, one
    per batch shape and model storage; ``ev.graphs``) and runs eagerly on
    the CPU; False always runs eagerly; True raises on a CPU state or
    with a mesh."""
    kw = dict(task_kwargs or {})
    group = data_group(mesh)

    def body(model: torch.nn.Module, feats: torch.Tensor, labels: torch.Tensor):
        logits = _logits(model(feats, **kw))
        xent = _softmax_xent(logits, labels)
        return torch.stack([-xent.mean(), (logits.argmax(-1) == labels).float().mean()])

    if _captures(capture, mesh):
        calls = CallGraphs(body, capture=capture, static=tuple(sorted(kw.items())))

        def ev(state: TrainState, feats, labels):
            state.model.eval()
            m = calls(state.model, feats, labels)
            return {"objf": m[0], "accuracy": m[1]}

        ev.graphs = calls
        return ev

    def ev(state: TrainState, feats, labels):
        model = state.model
        model.eval()
        with torch.no_grad():
            m = body(model, _to(feats, model), _to(labels, model))
            if group is not None:
                reduce_sum_([m], group, mean=True)
            return {"objf": m[0], "accuracy": m[1]}

    return ev


def _to(x, model: torch.nn.Module) -> torch.Tensor:
    dev = next(model.parameters()).device
    return torch.as_tensor(x).to(dev)


def finalize_batch_stats(state: TrainState, batches, model_kwargs=None,
                         mesh=None) -> TrainState:
    """Kaldi-style exact inference statistics for batch norm: a
    train-mode forward per calibration batch records every batch norm's
    (mean, biased var) without touching the running statistics; raw
    moments E[x] and E[x^2] are pooled across the batches (so the spread
    of the batch means counts) and written as the running statistics.
    With a ``mesh`` each rank forwards its shard of every (global)
    calibration batch and the moments are those of the whole batch."""
    model = state.model
    kw = dict(model_kwargs or {})
    sum_m: Dict[str, torch.Tensor] = {}
    sum_x2: Dict[str, torch.Tensor] = {}
    n = 0
    model.train()
    with torch.no_grad(), batch_moments(model) as moments, _reduced_bn(model, data_group(mesh)):
        for feats in batches:
            x = _to(feats, model)
            model(x if mesh is None else local_shard(x, mesh), **kw)
            for name, recs in moments.items():
                mean, var = recs.pop()
                x2 = var + mean * mean
                if name in sum_m:
                    sum_m[name] = sum_m[name] + mean
                    sum_x2[name] = sum_x2[name] + x2
                else:
                    sum_m[name], sum_x2[name] = mean, x2
            n += 1
    if n == 0:
        raise ValueError("finalize_batch_stats: no calibration batches")
    bns = dict(model.named_modules())
    with torch.no_grad():
        for name in sum_m:
            mean = sum_m[name] / n
            bns[name].running_mean.copy_(mean)
            bns[name].running_var.copy_(torch.clamp(sum_x2[name] / n - mean * mean, min=0.0))
    model.eval()
    return state


# the reference's aliases (`xvec_eval_step` / `am_eval_step` are one function here)
xvec_train_step = make_xvec_step
am_train_step = make_am_step
xvec_eval_step = am_eval_step = make_eval_step


@dataclasses.dataclass
class Trainer:
    """Outer loop: batches from an iterator, periodic diagnostics.

    ``batch_iter`` yields ChunkBatch-like objects (``feats``, ``labels``,
    ``task``) or (batch, weight) pairs; each step goes to ``steps[task]``.
    Held-out objectives: with ``valid_batches`` and ``eval_steps``, every
    batch is scored each ``eval_every`` steps and logged as
    'valid:<task>'.  Divergence guard (`get_successful_models`,
    `train/common.py:103-137`): a non-finite training objective at a log
    boundary aborts with the last good record.

    With a ``mesh`` (the reference's multi-process contract) every rank
    feeds its own shard of every batch; the staged arrays become DTensors
    over the mesh (`parallel.assemble_global_batch`) and the steps, built
    with the same mesh, reduce over it.
    """

    steps: Dict[str, Callable]
    state: TrainState
    log_every: int = 50
    logger: Optional[Callable[[int, str, Dict[str, float]], None]] = None
    history: list = dataclasses.field(default_factory=list)
    valid_batches: Optional[list] = None
    eval_steps: Optional[Dict[str, Callable]] = None
    eval_every: int = 200
    # with steps_per_dispatch=K and a task entry here, runs of K
    # consecutive same-shape same-task batches run as one superstep;
    # partial runs fall back to single steps
    supersteps: Optional[Dict[str, Callable]] = None
    steps_per_dispatch: int = 1
    # units staged to the device ahead of use; 0 copies at dispatch time
    device_prefetch: int = 1
    # steps completed by earlier run() calls (set when resuming), so
    # logged step numbers stay global
    steps_done: int = 0
    mesh: Optional[Any] = None

    def _device(self) -> torch.device:
        return next(self.state.model.parameters()).device

    def _run_valid(self, n: int):
        if not self.valid_batches or not self.eval_steps:
            return
        with span("train.eval"):
            for vb in self.valid_batches:
                ev = self.eval_steps.get(vb.task)
                if ev is None:
                    continue
                m = {k: float(v) for k, v in ev(self.state, vb.feats, vb.labels).items()}
                self.history.append((n, f"valid:{vb.task}", m))
                if self.logger:
                    self.logger(n, f"valid:{vb.task}", m)

    def _record(self, n: int, task: str, metrics: Dict) -> None:
        m = {k: float(v) for k, v in metrics.items()}
        if not np.isfinite(m.get("objf", 0.0)):
            raise RuntimeError(
                f"training diverged: non-finite objective at step {n} "
                f"(task {task}); last good metrics: "
                f"{self.history[-1] if self.history else None}"
            )
        self.history.append((n, task, m))
        if self.logger:
            self.logger(n, task, m)

    def _units(self, batch_iter: Iterable, num_steps: Optional[int]):
        """Plan the batch stream into dispatch units:
        ("super", task, feats (K,B,..), labels, weights (K,), K) or
        ("single", task, feats, labels, weight, 1).  Exactly ``num_steps``
        steps are planned and no further batch is pulled, so a sampler
        loses nothing between segmented run() calls."""
        K = self.steps_per_dispatch
        use_super = K > 1 and self.supersteps
        buf: list = []
        buf_key = None
        planned = 0

        def emit_buf():
            nonlocal buf
            if not buf:
                return
            task = buf[0][0].task
            if use_super and len(buf) == K and task in self.supersteps:
                yield ("super", task,
                       np.stack([b.feats for b, _ in buf]),
                       np.stack([b.labels for b, _ in buf]),
                       np.asarray([w for _, w in buf], np.float32), K)
            else:
                for b, w in buf:
                    yield ("single", b.task, b.feats, b.labels, np.float32(w), 1)
            buf = []

        for item in batch_iter:
            batch, weight = item if isinstance(item, tuple) else (item, 1.0)
            if not use_super or batch.task not in self.supersteps:
                for u in emit_buf():
                    planned += u[5]
                    yield u
                planned += 1
                yield ("single", batch.task, batch.feats, batch.labels, np.float32(weight), 1)
            else:
                key = (batch.task, batch.feats.shape)
                if buf and key != buf_key:
                    for u in emit_buf():
                        planned += u[5]
                        yield u
                buf_key = key
                buf.append((batch, weight))
                full = len(buf) == K
                at_end = num_steps is not None and planned + len(buf) >= num_steps
                if full or at_end:
                    for u in emit_buf():
                        planned += u[5]
                        yield u
            if num_steps is not None and planned >= num_steps:
                return
        yield from emit_buf()

    def _stage(self, units):
        """Copy units to the device ``device_prefetch`` ahead of use.  On a
        GPU the arrays go through pinned host memory and a side stream, so
        the copy of the next unit overlaps the current unit's compute."""
        if self.mesh is None:
            yield from self._stage_local(units)
            return
        from ..parallel.multihost import assemble_global_batch

        for kind, task, f, l, w, k in self._stage_local(units):
            spec = (superbatch_sharded if kind == "super" else batch_sharded)(self.mesh)
            yield (kind, task, assemble_global_batch(f, self.mesh, spec),
                   assemble_global_batch(l, self.mesh, spec), w, k)

    @staticmethod
    def _planned(units):
        """The units one by one, each pull (the wait on the batch stream
        and the stacking of a superstep's batches) timed as ``train.plan``."""
        units = iter(units)
        while True:
            with span("train.plan"):
                u = next(units, None)
            if u is None:
                return
            yield u

    def _stage_local(self, units):
        dev = self._device()
        depth = self.device_prefetch
        units = self._planned(units)
        if dev.type != "cuda":
            for kind, task, f, l, w, k in units:
                with span("train.stage"):
                    staged = (kind, task, torch.from_numpy(np.asarray(f)).to(dev),
                              torch.from_numpy(np.asarray(l)).to(dev),
                              torch.as_tensor(np.asarray(w, np.float32), device=dev), k)
                yield staged
            return
        copy_stream = torch.cuda.Stream(device=dev)

        def put(arr):
            host = torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()
            with torch.cuda.stream(copy_stream):
                return host.to(dev, non_blocking=True)

        def ready(item):
            kind, task, f, l, w, k, done = item
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(done)
            for t in (f, l, w):
                t.record_stream(cur)
            return kind, task, f, l, w, k

        q: collections.deque = collections.deque()
        for kind, task, f, l, w, k in units:
            with span("train.stage"):
                tensors = (put(f), put(l), put(np.asarray(w, np.float32)))
                done = torch.cuda.Event()
                done.record(copy_stream)
            q.append((kind, task, *tensors, k, done))
            if len(q) > depth:
                yield ready(q.popleft())
        while q:
            yield ready(q.popleft())

    def run(self, batch_iter: Iterable, num_steps: Optional[int] = None) -> TrainState:
        """Train on ``batch_iter`` for ``num_steps`` steps (or until it ends).
        The run is the span ``train``; inside it each unit's pull
        (``train.plan``), staging (``train.stage``) and step or superstep
        call (``train.dispatch``), the log-boundary reads (``train.log``)
        and the held-out evaluation (``train.eval``) are spans of their own."""
        with span("train"):
            n = 0
            base = self.steps_done

            def crossed(prev: int, cur: int, every: int) -> bool:
                return prev // every != cur // every

            for kind, task, feats, labels, weight, k in self._stage(
                self._units(batch_iter, num_steps)
            ):
                if kind == "super":
                    with span("train.dispatch"):
                        metrics = self.supersteps[task](self.state, feats, labels, weight)
                    prev, n = n, n + k
                    last = num_steps is not None and n >= num_steps
                    if crossed(prev, n, self.log_every) or last:
                        with span("train.log"):
                            self._record_superstep(base + n, task, k, metrics)
                else:
                    with span("train.dispatch"):
                        metrics = self.steps[task](self.state, feats, labels, weight)
                    prev, n = n, n + 1
                    last = num_steps is not None and n >= num_steps
                    if n % self.log_every == 0 or last:
                        with span("train.log"):
                            self._record(base + n, task, metrics)
                if crossed(prev, n, self.eval_every) or last:
                    self._run_valid(base + n)
                if num_steps is not None and n >= num_steps:
                    break
            self.steps_done = base + n
        return self.state

    def _record_superstep(self, n: int, task: str, k: int, metrics: Dict) -> None:
        """Guard every step of a superstep ending at step ``n``, and record
        the last value with the block mean."""
        vals = {m: v.cpu().numpy() for m, v in metrics.items()}
        objf = vals.get("objf")
        if objf is not None and not np.all(np.isfinite(objf)):
            bad = int(np.argmax(~np.isfinite(np.ravel(objf))))
            raise RuntimeError(
                f"training diverged: non-finite objective inside superstep "
                f"ending at step {n} (task {task}, step {bad + 1}/{k})"
            )
        rec = {m: float(np.ravel(v)[-1]) for m, v in vals.items()}
        rec.update({f"{m}_mean": float(v.mean()) for m, v in vals.items()})
        self._record(n, task, rec)

