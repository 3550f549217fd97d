"""CUDA graphs of the port's device work: the counterpart of `jax.jit`.

The reference compiles every program on its main path with `jax.jit`.
The port's counterpart is a CUDA graph: the kernels of one call recorded
once and replayed as one launch.  Two kinds of graph use the machinery
here:
- training steps (`train.graphs.StepGraphs`), which move the state they
  are given;
- `CallGraphs`: a function of device tensors and modules that moves no
  state (an extraction bucket's forward, the frontend chain, the bench's
  extraction and scoring programs, the held-out eval step).

`CallGraphs` keeps a graph per key: the inputs' shapes and dtypes,
`math_flags()`, the address, shape and dtype of every parameter and
buffer of the modules it is handed, each submodule's ``training`` flag,
and the static arguments (configs, task keywords).  A call copies its
tensor inputs into the graph's static buffers (host ones from pinned
memory, pinned first where they are not: `device`), replays, and returns
fresh outputs cloned from the graph's.  The first call of a key is its
own warm-up: it runs the function eagerly on the capture stream and
returns that real result; the capture that follows runs nothing.  A
graph binds the tensors its modules held at capture (the binding keeps
them alive), so `load_state_dict`, which copies in place, keeps the graph
and its replays read the new values, while a module moved onto new
storage (`model.to()`) gets a new key and a new capture, and the graphs
bound to its old tensors are let go.  A holder's graphs live as long as
the holder: a caller that keeps one across calls replays in a later call
what an earlier call captured.

Every graph on a device, training and inference, is captured into one
memory pool, held for the process by an anchor graph (`_Cuda.pool`): the
graphs hold the largest one's working memory and not the sum.  Sharing is
safe in any replay order: static inputs live outside the pool, a graph's
outputs stay allocated while it lives, and each replay's outputs are
cloned before anything else runs.  A capture or a replay that fails
raises `GraphCaptureError`; the eager call is never run in its place.

A kernel wrapper counts its launches with `count_launch`: at once when
it runs eagerly, and on every replay when it is recorded into a graph
(`on_replay`), so a launch count read around a path holds whether the
path ran eagerly or as replays.  A capture's warm-up call and its record,
and every copy in and replay, are spans of `utils.logging` (``graph.eager``,
``graph.capture``, ``graph.load``, ``graph.replay``).
"""

from __future__ import annotations

import contextlib
import gc
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .utils.logging import span

CALL_WARMUP = 1  # eager calls on the capture stream before an inference capture

# captures and replays since the counts were last set to 0: ``counts`` over
# every graph, ``call_counts`` over the inference graphs (`CallGraphs`) alone
counts = {"captures": 0, "replays": 0}
call_counts = {"captures": 0, "replays": 0}
_ALL: "weakref.WeakSet" = weakref.WeakSet()  # the holders of live graphs
_RECORDING: List[List[Callable[[], None]]] = []  # hooks of the captures in progress


class GraphCaptureError(RuntimeError):
    """A graph could not be captured or replayed."""


def reset_counts() -> None:
    for c in (counts, call_counts):
        for k in c:
            c[k] = 0


def register(holder) -> None:
    """Count ``holder.graphs`` (a dict of graphs) in `live_graphs`."""
    _ALL.add(holder)


def live_graphs() -> int:
    """Graphs held by live step and call functions."""
    return sum(len(s.graphs) for s in list(_ALL))


def math_flags() -> Tuple:
    """The flags a captured kernel choice depends on: TF32 for matmuls and
    cuDNN, cuDNN's algorithm selection and determinism."""
    cudnn = torch.backends.cudnn
    return (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            cudnn.enabled, cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled())


def on_replay(hook: Callable[[], None]) -> bool:
    """Inside an inference capture: run ``hook`` after every replay of the
    graph being captured, and return True.  Elsewhere return False."""
    if not _RECORDING:
        return False
    _RECORDING[-1].append(hook)
    return True


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel, added to ``wrapper.launches`` now,
    or on every replay when the launch is being recorded into a graph."""
    def add():
        wrapper.launches += 1

    if not on_replay(add):
        add()


class _Cuda:
    """The CUDA calls of a capture, in one place (a test substitutes them)."""

    def __init__(self):
        self.streams: Dict[int, torch.cuda.Stream] = {}
        self.pools: Dict[int, Tuple] = {}

    def capturable(self, dev: torch.device) -> bool:
        return dev.type == "cuda"

    @staticmethod
    def _index(dev: torch.device) -> int:
        return dev.index if dev.index is not None else torch.cuda.current_device()

    def _stream(self, dev: torch.device) -> torch.cuda.Stream:
        index = self._index(dev)
        if index not in self.streams:
            self.streams[index] = torch.cuda.Stream(device=index)
        return self.streams[index]

    def pool(self, dev: torch.device):
        """The device's one memory pool for every capture, held for the
        process by an anchor graph (a one-element add) captured into it
        first: the caching allocators (device and pinned host) refuse a
        capture into a pool whose every graph has died."""
        index = self._index(dev)
        if index not in self.pools:
            pool = torch.cuda.graph_pool_handle()
            x = torch.zeros(1, device=torch.device("cuda", index))
            anchor, _ = self.capture(x.device, lambda: x.add_(1), pool)
            self.pools[index] = (pool, anchor, x)
        return self.pools[index][0]

    @contextlib.contextmanager
    def side_stream(self, dev: torch.device) -> Iterator[None]:
        """Run the block on the capture stream, ordered after and before
        the current stream's work."""
        stream, cur = self._stream(dev), torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            cur.wait_stream(stream)

    def capture(self, dev: torch.device, fn: Callable[[], torch.Tensor], pool):
        """(graph, fn's output captured on the side stream into ``pool``)."""
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        enabled = gc.isenabled()
        gc.disable()  # no collection (and no frees it might trigger) mid-capture
        try:
            with self.side_stream(dev):
                graph.capture_begin(pool=pool)
                try:
                    out = fn()
                finally:
                    graph.capture_end()
        finally:
            if enabled:
                gc.enable()
        return graph, out


BACKEND = _Cuda()


# ------------------------------------------------------------ inference graphs


def _module_tensors(modules: Sequence[torch.nn.Module]):
    """(owner, "_parameters" or "_buffers", name, tensor) of every parameter
    and buffer of ``modules``, in a fixed order."""
    out = []
    for m in modules:
        for sub in m.modules():
            for kind in ("_parameters", "_buffers"):
                for name, t in getattr(sub, kind).items():
                    if t is not None:
                        out.append((sub, kind, name, t))
    return out


@contextlib.contextmanager
def _bound(entries) -> Iterator[None]:
    """The modules read the bound tensors of ``entries`` inside the block."""
    saved = [(sub, kind, name, getattr(sub, kind)[name]) for sub, kind, name, _ in entries]
    try:
        for sub, kind, name, t in entries:
            getattr(sub, kind)[name] = t
        yield
    finally:
        for sub, kind, name, t in saved:
            getattr(sub, kind)[name] = t


def _as_tensor(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x


class CapturedCall:
    """One captured graph of a `CallGraphs` function: static inputs, bound
    module tensors, the graph's outputs and its replay hooks."""

    def __init__(self, fn: Callable, args: Sequence, dev: torch.device):
        self.fn, self.device = fn, dev
        modules = [a for a in args if isinstance(a, torch.nn.Module)]
        with torch.no_grad():
            self.entries = [(sub, kind, name, t.detach())
                            for sub, kind, name, t in _module_tensors(modules)]
        self.args = [torch.empty(a.shape, dtype=a.dtype, device=dev)
                     if isinstance(a, torch.Tensor) else a for a in args]
        self.outs: Tuple[torch.Tensor, ...] = ()
        self.single = False
        self.hooks: List[Callable[[], None]] = []
        self.graph = None

    def _load(self, args: Sequence) -> None:
        with span("graph.load"):
            for buf, a in zip(self.args, args):
                if isinstance(a, torch.Tensor):
                    if buf.is_cuda and not a.is_cuda and not a.is_pinned():
                        a = a.pin_memory()
                    # the caching host allocator keeps a pinned block until this copy is done
                    buf.copy_(a, non_blocking=True)

    def _call(self):
        with torch.no_grad(), _bound(self.entries):
            return self.fn(*self.args)

    def _body(self) -> torch.Tensor:
        """What the graph holds: the function on the static inputs.  Records
        the outputs and the replay hooks the function registers."""
        _RECORDING.append([])
        try:
            out = self._call()
        finally:
            self.hooks = _RECORDING.pop()
        self.single = isinstance(out, torch.Tensor)
        self.outs = (out,) if self.single else tuple(out)
        return self.outs[0]

    def capture(self, args: Sequence, pool):
        """Warm up (the call's real result), then capture into ``pool``."""
        self._load(args)
        try:
            with span("graph.eager"), BACKEND.side_stream(self.device):
                for _ in range(CALL_WARMUP):
                    first = self._call()
            with span("graph.capture"):
                self.graph, _ = BACKEND.capture(self.device, self._body, pool)
        except Exception as e:
            raise GraphCaptureError(
                f"capturing {getattr(self.fn, '__qualname__', self.fn)} failed "
                f"({type(e).__name__}: {e}); the eager call is capture=False") from e
        counts["captures"] += 1
        call_counts["captures"] += 1
        for t in ((first,) if isinstance(first, torch.Tensor) else first):
            if t.is_cuda:  # made on the capture stream, read on the caller's
                t.record_stream(torch.cuda.current_stream(t.device))
        return first

    def run(self, args: Sequence):
        """Copy the inputs in, replay, and return fresh outputs."""
        self._load(args)
        with span("graph.replay"):
            try:
                self.graph.replay()
            except Exception as e:
                raise GraphCaptureError(f"replaying {getattr(self.fn, '__qualname__', self.fn)} "
                                        f"failed ({type(e).__name__}: {e})") from e
            counts["replays"] += 1
            call_counts["replays"] += 1
            outs = tuple(o.clone() for o in self.outs)
        for hook in self.hooks:
            hook()
        return outs[0] if self.single else outs


class CallGraphs:
    """``fn(*args)``, a function that moves no state, as graph replays on a
    CUDA device.  Its positional arguments are modules (bound and keyed by
    their tensors), tensors or numpy arrays (copied into static buffers;
    shapes and dtypes keyed), and anything else, which is keyed as a
    static argument and passed as it is.  ``fn`` returns a tensor or a
    tuple of tensors, and runs without gradients.

    ``capture`` (the counterpart of `jax.disable_jit`): None replays on a
    CUDA device and runs eagerly on the CPU; False always runs eagerly;
    True raises on the CPU.  ``device`` is where a call without modules
    runs (a call with modules runs on the first one's device); ``static``
    is keyed with every call."""

    def __init__(self, fn: Callable, capture: Optional[bool] = None,
                 device: Optional[torch.device] = None, static: Tuple = ()):
        self.fn, self.capture, self.static = fn, capture, static
        self.device = None if device is None else torch.device(device)
        self.graphs: Dict[Tuple, CapturedCall] = {}
        register(self)

    def _device(self, args) -> torch.device:
        for a in args:
            if isinstance(a, torch.nn.Module):
                return next(a.parameters()).device
        if self.device is None:
            raise ValueError("CallGraphs: no module and no device to run on")
        return self.device

    def key(self, args) -> Tuple[Tuple, Tuple]:
        """(what the graph is specialised to, the identity of the module
        tensors it is bound to)."""
        sig, modules = [], []
        for a in args:
            if isinstance(a, torch.nn.Module):
                modules.append(a)
                sig.append(("module", tuple(sub.training for sub in a.modules())))
            elif isinstance(a, torch.Tensor):
                sig.append((tuple(a.shape), a.dtype, a.device.type))
            else:
                sig.append(("static", a))
        ident = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                      for *_, t in _module_tensors(modules))
        return (self.static, tuple(sig), math_flags()), ident

    def eager(self, dev: torch.device, args):
        with torch.no_grad():
            return self.fn(*[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args])

    def __call__(self, *args):
        args = [_as_tensor(a) for a in args]
        dev = self._device(args)
        if self.capture is False or not BACKEND.capturable(dev):
            if self.capture:
                raise ValueError(f"capture=True needs a CUDA device: a call on {dev} runs "
                                 f"eagerly (capture=None or False)")
            return self.eager(dev, args)
        sig, ident = self.key(args)
        g = self.graphs.get((sig, ident))
        if g is None:
            # graphs bound to other module tensors (a model moved onto new storage)
            for k in [k for k in self.graphs if k[1] != ident]:
                del self.graphs[k]
            g = CapturedCall(self.fn, args, dev)
            out = g.capture(args, BACKEND.pool(dev))
            self.graphs[(sig, ident)] = g
            return out
        return g.run(args)
