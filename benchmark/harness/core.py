"""What every cell shares: finding its files by name, the run's context,
spans and counters, and the checks that decide ``correct``.

A cell of `BENCHMARK.json` names a configuration and a traffic mix.  The
harness finds them as files, by name alone:
- ``benchmark/configs/<config>.json``: the model's sizes as run;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, whose
  ``driver`` key names ``benchmark/drivers/<driver>.py``;
- ``benchmark/models/<model>.py``: everything of one model kind, by the
  configuration's ``model`` key (`model_kind`);
- ``benchmark/limits/<cell>.json``: the limits of the numbers compared;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.
A later change adds a cell, a mix, a metric or a model kind by adding
files and entries.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import math
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Mapping, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A Python file loaded by its path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_KINDS: Dict[Path, ModuleType] = {}


def model_kind(cfg: Mapping, root: Path = BENCH_DIR) -> ModuleType:
    """The module of the configuration's model kind,
    ``<root>/models/<model>.py``, loaded once; a kind with no file raises
    `FileNotFoundError` naming the file."""
    path = (Path(root) / "models" / f"{cfg['model']}.py").resolve()
    if path not in _KINDS:
        _KINDS[path] = load_module(path)
    return _KINDS[path]


def merge(base: Dict, over: Optional[Dict]) -> Dict:
    """``base`` with ``over``'s keys put in, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    """A cell's entry, its configuration, mix and limits, as files give them."""

    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    root: Path = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def model(self) -> ModuleType:
        """The module of the configuration's model kind (`model_kind`)."""
        return model_kind(self.config, self.root)


def find_cell(bench: Dict, name: str, root: Path = BENCH_DIR,
              overrides: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``bench`` (a parsed BENCHMARK.json), its files
    read from under ``root``; ``overrides`` ({"config": {...}, "traffic":
    {...}}) change them, for the tests' small sizes."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    overrides = overrides or {}
    config = merge(load_json(root / "configs" / f"{entry['config']}.json"), overrides.get("config"))
    traffic = merge(load_json(root / "traffic" / f"{entry['traffic']}.json"),
                    overrides.get("traffic"))
    limits = merge(load_json(root / "limits" / f"{name}.json"), overrides.get("limits"))
    return Cell(name, entry, config, traffic, limits, Path(root))


def driver_for(cell: Cell, root: Path = BENCH_DIR) -> ModuleType:
    return load_module(root / "drivers" / f"{cell.traffic['driver']}.py")


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``.  A metric with a
    ``workloads`` key belongs to the cells it lists; a per-layer metric
    without one to every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


# ------------------------------------------------------------- spans, counts


class Spans:
    """Host-clock spans around the calls into each layer, summed in
    memory: name -> [seconds, count].  With ``record`` (a traced run) each
    span is also a `torch.profiler.record_function` range, so the trace
    can say what the host was doing in a gap."""

    def __init__(self, record: bool = False):
        self.totals: Dict[str, List[float]] = {}
        self.record = record

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.record:
            import torch

            rf = torch.profiler.record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                tot = self.totals.setdefault(name, [0.0, 0])
                tot[0] += time.perf_counter() - t0
                tot[1] += 1

    def seconds(self, name: str) -> float:
        return self.totals.get(name, [0.0, 0])[0]


@dataclasses.dataclass
class Check:
    """One number compared with its limit; ``ok`` when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values, the checks, and
    what the per-layer readers read (spans, counts of work, the window)."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    window_s: float
    setup_s: float
    memory_peak_bytes: int
    work: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spans: Optional[Spans] = None
    trace: Optional[Any] = None  # profiling.TraceSummary of a traced window

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


def limit(cell: Cell, name: str) -> float:
    return float(cell.limits["limits"][name])


@dataclasses.dataclass
class RunContext:
    """One run of one cell, as a driver sees it."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    process_start: float  # time.perf_counter() reading of the process's start
    controls: tuple = ()  # precisions whose gaps to the reference are read too

    def sub_seed(self, tag: int) -> int:
        """A seed of its own for each thing the run makes from its seed."""
        return (int(self.seed) * 1_000_003 + tag) % (1 << 62)


class Marks:
    """Seconds since the process started at each named point of set-up,
    for standard error."""

    def __init__(self, ctx: RunContext):
        self.t0 = ctx.process_start
        self.marks: Dict[str, float] = {}

    def __call__(self, name: str) -> None:
        self.marks[name] = round(time.perf_counter() - self.t0, 3)
