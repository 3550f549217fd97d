"""The compiled training step: CE steps and supersteps as CUDA graphs.

The port's counterpart of the reference's jitted step (`_jit_step`) and
its `lax.scan` superstep.  On a CUDA state a step is one replay of a
captured graph, and a K-step superstep one replay of a graph that holds
its K steps unrolled in order, as the scan holds them.  The numbers are
the eager step's: the graph runs the same kernels on the same inputs,
and the optimizer chain reads its per-step scalars (learning rate, bias
corrections, shrink factor) from a device row the host fills before each
replay with the float32 numbers it computes for the eager step
(`optim.OptimizerChain.scalar_rows`).

`StepGraphs` keeps one graph per `graph_key`: the task's keyword
arguments, the batch's shapes and dtypes, K, the TF32 and cuDNN flags,
and the address, shape and dtype of every tensor the step reads or
writes (`state_tensors`: parameters, buffers, optimizer state).  A graph
replays against addresses, so a state whose tensors moved
(`TrainState.clone()`, `load_checkpoint`, a replaced ``opt_state``) gets
a graph of its own; `load_state_dict` copies in place and keeps it (as
does a new state whose every tensor took a freed one's address, shape
and dtype: the graph reads and writes exactly those).

A capture warms the step up on a side stream (real steps, which move the
state), captures it (which runs nothing), and puts every state tensor
back from a snapshot, so the first replay is the first real step.  Each
replay copies the batch into the graph's static buffers, fills the
scalar row and returns fresh tensors cloned from the graph's outputs.

Every graph on a device, training and inference, is captured into the
one memory pool of `sepi_tpu_torch.graphs` (which holds the capture
machinery: the side stream, the pool, the counts), so the graphs hold the
largest one's working memory and not the sum, and a later capture reuses
what a dead graph held.  (A pool per graph, or per step function, is not
given back to the allocator when its graphs die: the drivers' buckets ran
a card out of memory that way.)  Sharing is safe in any replay order: the
static inputs live outside the pool, a graph's outputs stay allocated (no
other capture is given them), and each replay's outputs are cloned before
anything else runs, so another graph's replay may only overwrite
temporaries and outputs already read; replays run in turn on the caller's
stream.  A capture or a replay that fails raises `GraphCaptureError`; the
eager step is never run in its place.
"""

from __future__ import annotations

import copy
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# the capture machinery lives in sepi_tpu_torch.graphs; its names stay exported here
from ..graphs import (BACKEND, GraphCaptureError, _Cuda, counts, live_graphs,  # noqa: F401
                      math_flags, register, reset_counts)
from .optim import StepScalars

WARMUP = 2  # eager iterations on the side stream before a capture


def state_tensors(state):
    """Parameters, buffers and optimizer-state tensors, in a fixed order."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            for k in sorted(x):
                yield from walk(x[k])

    yield from (t.data for t in state.model.parameters())
    yield from state.model.buffers()
    yield from walk(state.opt_state)


def graph_key(state, task_kwargs: Dict, feats: torch.Tensor, labels: torch.Tensor,
              k: Optional[int] = None) -> Tuple:
    """What a graph is valid for: the task, the batch's shapes and dtypes,
    K (None for a single step), the math flags, and the identity of every
    state tensor."""
    return (tuple(sorted(task_kwargs.items())), k, feats.device,
            tuple(feats.shape), feats.dtype, tuple(labels.shape), labels.dtype, math_flags(),
            tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in state_tensors(state)))


def _model_device(state) -> torch.device:
    return next(state.model.parameters()).device


class CapturedStep:
    """One captured graph with its static inputs and outputs."""

    def __init__(self, body: Callable, tx, state, feats, labels, k: Optional[int]):
        dev = _model_device(state)
        rows = 1 if k is None else k
        self.body, self.tx, self.k, self.device = body, tx, k, dev
        self.model = weakref.ref(state.model)
        self.feats = torch.empty(feats.shape, dtype=feats.dtype, device=dev)
        self.labels = torch.empty(labels.shape, dtype=labels.dtype, device=dev)
        self.weights = torch.zeros(() if k is None else (k,), dtype=torch.float32, device=dev)
        self.scalars = torch.zeros((rows, len(StepScalars._fields)), dtype=torch.float32,
                                   device=dev)
        self.names: List[str] = []
        self.out: Optional[torch.Tensor] = None
        self.graph = None

    def _steps(self, state) -> torch.Tensor:
        """What the graph holds: the step (or K steps) on the static
        buffers, the metrics stacked to (M,) or (M, K).  The state's step
        counts are left as they were: `run` advances them."""
        body, step0, count0 = self.body, state.step, state.opt_state["count"]
        try:
            if self.k is None:
                m = body(state, self.feats, self.labels, self.weights, scalars=self.scalars[0])
                self.names = list(m)
                return torch.stack([m[n] for n in self.names])
            ms = [body(state, self.feats[i], self.labels[i], self.weights[i],
                       scalars=self.scalars[i]) for i in range(self.k)]
            self.names = list(ms[0])
            return torch.stack([torch.stack([m[n] for m in ms]) for n in self.names])
        finally:
            state.step, state.opt_state["count"] = step0, count0

    def _load(self, state, feats, labels, weights) -> None:
        self.feats.copy_(feats)
        self.labels.copy_(labels)
        if isinstance(weights, torch.Tensor):  # the Trainer stages a single weight as (1,)
            self.weights.copy_(weights.reshape(self.weights.shape))
        elif self.k is None:
            self.weights.fill_(float(weights))
        else:
            self.weights.copy_(torch.as_tensor(weights, dtype=torch.float32))
        rows = torch.from_numpy(self.tx.scalar_rows(state.opt_state["count"],
                                                    len(self.scalars)))
        on_card = self.scalars.is_cuda
        self.scalars.copy_(rows.pin_memory() if on_card else rows, non_blocking=on_card)

    def capture(self, state, feats, labels, weights, pool) -> None:
        """Warm up on the side stream, capture into ``pool``, and put every
        state tensor back as it was before the warm-up."""
        self._load(state, feats, labels, weights)
        tensors = list(state_tensors(state))
        try:
            with torch.no_grad():
                snapshot = [t.clone() for t in tensors]
            try:
                with BACKEND.side_stream(self.device):
                    for _ in range(WARMUP):
                        self._steps(state)
                # the graph is bound to these tensors, whatever the state holds later
                bound = copy.copy(state)
                self.graph, self.out = BACKEND.capture(self.device, lambda: self._steps(bound),
                                                       pool)
            finally:
                with torch.no_grad():
                    for t, s in zip(tensors, snapshot):
                        t.copy_(s)
        except Exception as e:
            raise GraphCaptureError(
                f"capturing the {'step' if self.k is None else f'K={self.k} superstep'} failed "
                f"({type(e).__name__}: {e}); the eager step is capture=False") from e
        counts["captures"] += 1

    def run(self, state, feats, labels, weights) -> Dict[str, torch.Tensor]:
        """Copy the inputs in, replay, advance the state's counts as the
        eager step does, and return fresh metric tensors."""
        self._load(state, feats, labels, weights)
        try:
            self.graph.replay()
        except Exception as e:
            raise GraphCaptureError(f"replaying a captured step failed ({type(e).__name__}: "
                                    f"{e})") from e
        counts["replays"] += 1
        n = 1 if self.k is None else self.k
        state.model.train()
        state.step += n
        state.opt_state["count"] += n
        out = self.out.clone()
        return {name: out[i] for i, name in enumerate(self.names)}


class StepGraphs:
    """A CE step (``superstep=False``: ``step(state, feats, labels,
    weight)``) or a superstep (``sstep(state, feats (K, B, ...), labels
    (K, B, ...), weights (K,))``) that runs as graph replays on a CUDA
    state.  ``body(state, feats, labels, weight, scalars=None)`` is one
    eager CE step whose chain ``tx`` reads ``scalars`` when given;
    ``eager`` is what a CPU state runs when ``capture`` is None.
    ``capture=True`` on a CPU state raises."""

    def __init__(self, body: Callable, tx, task_kwargs: Dict, eager: Callable,
                 superstep: bool = False, capture: Optional[bool] = None):
        self.body, self.tx, self.eager = body, tx, eager
        self.task_kwargs = dict(task_kwargs)
        self.superstep, self.capture = superstep, capture
        self.graphs: Dict[Tuple, CapturedStep] = {}
        register(self)

    def _evict_dead(self) -> None:
        for key in [key for key, g in self.graphs.items() if g.model() is None]:
            del self.graphs[key]

    def __call__(self, state, feats, labels, weights=1.0):
        if not BACKEND.capturable(_model_device(state)):
            if self.capture:
                raise ValueError("capture=True needs a CUDA state: a CPU step runs eagerly "
                                 "(capture=None or False)")
            return self.eager(state, feats, labels, weights)
        k = int(feats.shape[0]) if self.superstep else None
        key = graph_key(state, self.task_kwargs, feats, labels, k)
        g = self.graphs.get(key)
        if g is None:
            self._evict_dead()
            g = CapturedStep(self.body, self.tx, state, feats, labels, k)
            g.capture(state, feats, labels, weights, BACKEND.pool(_model_device(state)))
            self.graphs[key] = g
        elif g.model() is not state.model:
            # a new state whose tensors all took the old one's addresses:
            # the graph reads and writes exactly them
            g.model = weakref.ref(state.model)
        return g.run(state, feats, labels, weights)


def eager_superstep(body: Callable) -> Callable:
    """K eager steps in order, each metric stacked to (K,)."""
    def sstep(state, feats, labels, weights: Sequence):
        out = [body(state, feats[k], labels[k], weights[k]) for k in range(feats.shape[0])]
        return {m: torch.stack([o[m] for o in out]) for m in out[0]}

    return sstep
