"""The benchmark's general machinery, driven by data: a cell's entry in
``BENCHMARK.json`` names its configuration and traffic; the files that
belong to them are found by name:

- ``configs/<config>.json``: the configuration as it is run (widths,
  depths, grids, precision), with ``source``, ``assumed`` and ``reduced``;
- ``workloads/<cell>.json``: the cell's traffic kind, the mix's
  parameters, the chips it needs, and the limits of the comparison that
  decides ``correct``;
- ``traffic/<kind>.py``: the runner of one kind of traffic (``Traffic``);
- ``metrics/<metric>.py``: the reader of one per-layer metric (``read``).

A run: set-up (imports, kernels built or found built, weights and inputs
from the seed, one warm-up of the cell's own shapes), the measured window,
the check that nothing of JAX or the JAX package is loaded, the peak of
device memory, the comparison with the plain reference, and one result
line. With ``trace`` the window runs under ``torch.profiler`` (device
activity only) and the per-layer metrics are read from it, from the
benchmark's own host spans and from the traffic's records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names that no run may load (compared whole: the port's
# ``dgdm_tpu_torch`` is not ``dgdm_tpu``)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dgdm_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One benchmark cell with everything its files say."""

    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str

    @property
    def kind(self) -> str:
        return self.workload["kind"]

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


def _applies(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, root: str = ROOT,
              bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    its workload file and the metrics it reports."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _load_json(os.path.join(bench_dir, "workloads",
                                       f"{name}.json"))
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json gives {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    config = _load_json(os.path.join(bench_dir, "configs",
                                     f"{entry['config']}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, entry["chips"], config, workload, e2e, layer,
                bench_dir)


def traffic_class(cell: Cell):
    """``traffic/<kind>.py``'s ``Traffic``."""
    return importlib.import_module(f"perfbench.traffic.{cell.kind}").Traffic


def metric_reader(cell: Cell, name: str):
    """``metrics/<name>.py``'s ``read``, loaded by path (a metric's name
    may hold dots)."""
    path = os.path.join(cell.bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_start_time() -> float:
    """This process's start on the ``time.time`` clock (Linux ``/proc``);
    the harness's own import time where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED_AT


_IMPORTED_AT = time.time()


class Spans:
    """Host spans of one run, on ``time.perf_counter``: (name, start,
    end). ``span`` may nest and may be entered from several threads."""

    def __init__(self):
        self.items: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def wrap(self, name: str, fn):
        """``fn`` with each call recorded as a span ``name``."""
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        wrapped.__wrapped__ = fn
        return wrapped

    def total(self, name: str, lo: float = float("-inf"),
              hi: float = float("inf")) -> float:
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.items
                   if n == name and e > lo and s < hi)

    def at(self, t: float, names) -> Optional[str]:
        """The innermost span among ``names`` that holds ``t``."""
        best = None
        for n, s, e in self.items:
            if n in names and s <= t <= e and (best is None
                                               or s >= best[1]):
                best = (n, s)
        return None if best is None else best[0]


@dataclasses.dataclass
class Window:
    """The measured window: its host-clock bounds, the traffic's records,
    and with a trace the device's kernels on the host clock."""

    t0: float
    t1: float
    spans: Spans
    records: dict
    config: dict
    kernels: Optional[List[tuple]] = None     # (name, start, end)
    busy_s: Optional[float] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def kernel_seconds(self, substring: str, lo: float = None,
                       hi: float = None) -> float:
        """Device seconds of the kernels whose name holds ``substring``,
        inside [lo, hi] (the window by default)."""
        lo = self.t0 if lo is None else lo
        hi = self.t1 if hi is None else hi
        if self.kernels is None:
            return 0.0
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.kernels
                   if substring in n and e > lo and s < hi)


# the marker kernel that ties the trace's clock to the host's
_MARKER = "spin_kernel"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """``torch.profiler`` over the window, device activity only. A short
    sleep kernel launched right after a synchronise at the window's start
    ties the trace's clock to ``time.perf_counter``."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t_marker = None

    def start(self):
        torch = self.torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_marker = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self):
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def kernels(self) -> List[tuple]:
        """(name, start, end) of every kernel, copy and set on the host
        clock."""
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            events = _load_json(path)["traceEvents"]
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        marks = [e for e in dev if _MARKER in e.get("name", "")]
        if not marks:
            raise RuntimeError("the trace holds no marker kernel: the "
                               "profiler recorded no device activity")
        offset = self.t_marker - float(marks[0]["ts"]) * 1e-6
        return [(e["name"], float(e["ts"]) * 1e-6 + offset,
                 (float(e["ts"]) + float(e.get("dur", 0.0))) * 1e-6 + offset)
                for e in dev if e is not marks[0]]


def busy_and_gaps(kernels, t0: float, t1: float):
    """Seconds some operation ran on the device inside [t0, t1], and the
    idle gaps between them."""
    iv = _union([(max(s, t0), min(e, t1)) for _, s, e in kernels
                 if e > t0 and s < t1])
    busy = sum(e - s for s, e in iv)
    gaps, last = [], t0
    for s, e in iv:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    return busy, gaps


def breakdown(window: Window, gap_names) -> dict:
    """The 10 device operations that took most time, and the idle time by
    the span the host was in (``gap_names``, innermost first; "other")."""
    by_op: Dict[str, float] = {}
    for n, s, e in window.kernels:
        if e > window.t0 and s < window.t1:
            by_op[n] = by_op.get(n, 0.0) + min(e, window.t1) - max(s, window.t0)
    _, gaps = busy_and_gaps(window.kernels, window.t0, window.t1)
    by_span: Dict[str, float] = {}
    for s, e in gaps:
        name = window.spans.at(0.5 * (s + e), gap_names) or "other"
        by_span[name] = by_span.get(name, 0.0) + (e - s)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, lines): every compared number against its limit."""
    ok = True
    lines = []
    for name, value in numbers.items():
        limit = limits[name]
        good = value == value and value <= limit
        ok = ok and good
        lines.append(f"{name} {value!r} limit {limit!r}"
                     f"{'' if good else ' FAIL'}")
    return ok, lines
