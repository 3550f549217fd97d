"""Structured metrics logging, profiler traces, and the program's spans
and counters.

Port of `sepi_tpu/utils/logging.py`: per-job logfiles parsed by regex in
the reference become jsonl records; `profile` writes a `torch.profiler`
trace (CPU and, on a GPU, CUDA activity) of the enclosed block.

The port's own tracer (no counterpart in the reference): `span(name)`
around the work of one layer, `count(name, n)` beside it.
- Spans are off by default.  Off, `span` returns one shared null context
  after one flag check: no allocation, no clock read, no
  `record_function`.  On (`enable`, `tracing`, or inside `profile`), a
  span keeps ``(name, start_ns, end_ns, parent, root, id)`` in memory on
  `time.perf_counter_ns` and is also a ``record_function("sepi.<name>")``
  range, so a profiler trace names the layer on the clock of its device
  events.  Each thread nests its spans on its own stack; an outermost
  span opens a new ``root`` id that its children share.
- Counters are plain adds, always on, made on one thread.
- `totals` sums the spans by name (seconds, count, self seconds: the
  duration less what the span's children cover); `reset` zeroes spans
  and counters.
A span never synchronises the device: one around a device read times the
wait where it happens.  A span is never left open across a ``yield``, or
it would time the generator's consumer.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional


class MetricsLogger:
    """Append-only jsonl metrics stream + stdout echo."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, task: str, metrics: Dict[str, float]) -> None:
        rec = {"t": round(time.time() - self._t0, 3), "step": step, "task": task, **metrics}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            kv = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"[{rec['t']:8.1f}s] step {step:>6} {task:<5} {kv}", flush=True)

    # Trainer-compatible callable
    __call__ = log

    def close(self):
        if self._f:
            self._f.close()


# ------------------------------------------------------------------ tracing

_ON = False
_NULL = contextlib.nullcontext()
_IDS = itertools.count(1)
_LOCAL = threading.local()  # .stack: this thread's open spans
_SPANS: List["SpanRecord"] = []
_COUNTERS: Dict[str, int] = {}


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` is the enclosing span's ``id`` on the
    same thread (None for an outermost span), ``root`` the outermost's."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int
    id: int


class _Span:
    __slots__ = ("name", "id", "parent", "root", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import torch

        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.id = next(_IDS)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.rf = torch.profiler.record_function(f"sepi.{self.name}")
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _LOCAL.stack.pop()
        _SPANS.append(SpanRecord(self.name, self.t0, t1, self.parent, self.root, self.id))
        return False


def span(name: str):
    """A context manager timing the block as the span ``name`` while
    spans are on; off, the shared null context."""
    if not _ON:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


@contextlib.contextmanager
def tracing(on: bool = True):
    """Spans on (or off) inside the block, as they were after it."""
    global _ON
    was, _ON = _ON, on
    try:
        yield
    finally:
        _ON = was


def reset() -> None:
    """Forget every closed span and zero every counter."""
    _SPANS.clear()
    _COUNTERS.clear()


def spans() -> List[SpanRecord]:
    """The closed spans, in the order they closed."""
    return list(_SPANS)


def counters() -> Dict[str, int]:
    return dict(_COUNTERS)


def totals() -> Dict[str, Dict[str, float]]:
    """name -> {"seconds", "count", "self_seconds"} over the closed spans."""
    recs = list(_SPANS)
    covered: Dict[int, int] = {}
    for r in recs:
        if r.parent is not None:
            covered[r.parent] = covered.get(r.parent, 0) + (r.end_ns - r.start_ns)
    out: Dict[str, Dict[str, float]] = {}
    for r in recs:
        t = out.setdefault(r.name, {"seconds": 0.0, "count": 0, "self_seconds": 0.0})
        d = r.end_ns - r.start_ns
        t["seconds"] += d * 1e-9
        t["count"] += 1
        t["self_seconds"] += (d - covered.get(r.id, 0)) * 1e-9
    return out


@contextlib.contextmanager
def profile(log_dir: Optional[str], enabled: bool = True):
    """`torch.profiler` trace of the block, written to
    ``log_dir/trace.json`` (Chrome trace format) when it ends; the
    program's spans are on inside it, so the trace names its layers."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, tracing(True):
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

