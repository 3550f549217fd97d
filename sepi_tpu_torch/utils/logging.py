"""Structured metrics logging and profiler traces.

Port of `sepi_tpu/utils/logging.py`: per-job logfiles parsed by regex in
the reference become jsonl records; `profile` writes a `torch.profiler`
trace (CPU and, on a GPU, CUDA activity) of the enclosed block.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


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


@contextlib.contextmanager
def profile(log_dir: Optional[str], enabled: bool = True):
    """`torch.profiler` trace of the block, written to
    ``log_dir/trace.json`` (Chrome trace format) when it ends."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
