"""The measured window: the host clock around it, and in a traced run
the profiler's events reduced in memory (no trace file is written).

`TraceSummary` holds what the per-layer readers and the result line take
from the device trace: the seconds in which any device operation ran
(the union of their intervals), the traced window's length, the device
time of each kernel name, and the longest idle gaps, each named by the
harness span and the host operation that covered its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernels: Dict[str, float]  # device seconds by operation name
    gaps: List[Tuple[str, float]]  # longest idle gaps: (what the host did, seconds)
    device_events: int

    def kernel_seconds(self, needle: str) -> float:
        return sum(s for n, s in self.kernels.items() if needle in n)

    def breakdown(self) -> Dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:10]]}


def _times(e) -> Tuple[float, float]:
    """(start, end) in seconds of a kineto event."""
    if hasattr(e, "start_ns"):
        s = e.start_ns() * 1e-9
        return s, s + e.duration_ns() * 1e-9
    s = e.start_us() * 1e-6
    return s, s + e.duration_us() * 1e-6


def _annotation(name: str) -> bool:
    """A host range mirrored on the device timeline, not a device operation."""
    return name.startswith(("bench.", "ProfilerStep"))


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce a profiler's kineto events: device intervals merged into
    busy time, per-name device seconds, and the idle gaps between busy
    intervals labelled by the host range that covered each gap's middle."""
    dev, host = [], []
    for e in events:
        kind = str(e.device_type())
        start, end = _times(e)
        if end < start:
            continue
        if "CUDA" in kind:
            if not _annotation(e.name()):
                dev.append((start, end, e.name()))
        elif "CPU" in kind:
            host.append((start, end, e.name()))
    kernels: Dict[str, float] = {}
    for s, t, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (t - s)
    dev.sort()
    merged: List[List[float]] = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    labelled = []
    for g0, g1 in gaps[:10]:
        mid = 0.5 * (g0 + g1)
        span, op, op_len = "", "", -1.0
        for s, t, n in host[:bisect.bisect_right(starts, mid)]:
            if t >= mid:
                if n.startswith("bench."):
                    span = n[len("bench."):]
                elif not n.startswith("ProfilerStep") and (op_len < 0 or t - s < op_len):
                    op, op_len = n, t - s
        labelled.append((f"{span or 'outside spans'}: {op or 'Python, no torch op'}", g1 - g0))
    return TraceSummary(busy, window_s, kernels, labelled, len(dev))


def host_counters() -> Dict[str, float]:
    """This process's CPU seconds, page faults and context switches so
    far, and the machine's CPU seconds stolen by its host (Linux)."""
    import os
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    out = {"user_s": r.ru_utime, "sys_s": r.ru_stime, "minor_faults": r.ru_minflt,
           "major_faults": r.ru_majflt, "voluntary_switches": r.ru_nvcsw,
           "involuntary_switches": r.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            ticks = [float(x) for x in f.readline().split()[1:]]
        hz = os.sysconf("SC_CLK_TCK")
        out["machine_busy_s"] = (sum(ticks[:3]) + sum(ticks[5:7])) / hz
        out["machine_steal_s"] = ticks[7] / hz if len(ticks) > 7 else 0.0
    except (OSError, ValueError, IndexError):
        pass
    return out


class Window:
    """The timed window: ``start()`` and ``stop()`` on the host clock after
    a device synchronize; with ``trace`` a `torch.profiler` runs over it
    and ``summary`` holds its reduction."""

    def __init__(self, device, trace: bool):
        self.device, self.trace = device, trace
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.summary: Optional[TraceSummary] = None
        self.host: Dict[str, float] = {}

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> float:
        import torch

        self._sync()
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        self.host = host_counters()
        self.t0 = time.perf_counter()
        return self.t0

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def stop(self) -> float:
        self._sync()
        self.t1 = time.perf_counter()
        after = host_counters()
        self.host = {k: after[k] - self.host.get(k, 0.0) for k in after}
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.summary = summarize(self.prof.profiler.kineto_results.events(), self.seconds)
            self.prof = None
        return self.seconds

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

