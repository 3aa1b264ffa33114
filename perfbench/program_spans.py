"""The program's own host spans in a traced run's window, and the device's
idle time named by them.

The program's recorder (``dgdm_tpu_torch.core.profiling.TRACER``) records
while a ``torch.profiler`` session runs, so a run with ``--trace 1`` holds
the spans of its window (``DeviceTrace`` profiles exactly the window) and a
run with ``--trace 0`` none. Spans are ``(name, start, end)`` on
``time.perf_counter``, the clock of the window and of the benchmark's own
spans. A program without the recorder gives no spans, and the readers that
use them read nothing.

    python3 perfbench/program_spans.py --workload <cell> --seed <n> \\
        --seconds <s>

runs a cell's set-up and traced window as ``run.py --trace 1`` does (no
comparison follows) and prints one JSON line: the device's idle seconds by
the innermost span that held the host, the benchmark's or the program's;
each program span's count and seconds; the cell's per-layer metrics; and
the drift between the trace's clock tie before the window and a second one
after it. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402


def in_window(window: harness.Window) -> List[tuple]:
    """The program's spans that lie inside the window, (name, start, end);
    none where the program has no recorder."""
    try:
        from dgdm_tpu_torch.core.profiling import TRACER
    except ImportError:
        return []
    return [(n, s, e) for n, s, e, _ in TRACER.spans()
            if window.t0 <= s and e <= window.t1]


def seconds(window: harness.Window, *names: str) -> Optional[float]:
    """The seconds of the program's spans ``names`` in the window; None
    where the window holds none of them."""
    spans = [e - s for n, s, e in in_window(window) if n in names]
    return sum(spans) if spans else None


def idle_by_span(window: harness.Window, names) -> Dict[str, float]:
    """The device's idle seconds in the window by the innermost span among
    ``names`` that held the host at each gap's middle ("other": none)."""
    _, gaps = harness.busy_and_gaps(window.kernels, window.t0, window.t1)
    out: Dict[str, float] = {}
    for s, e in gaps:
        name = window.spans.at(0.5 * (s + e), names) or "other"
        out[name] = out.get(name, 0.0) + (e - s)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


class TiedTrace(harness.DeviceTrace):
    """``harness.DeviceTrace`` with a second marker kernel after the window.
    The trace lists its events in no fixed order, so the clock is tied at
    the earlier marker; ``drift_us`` is how far the later one lands from
    its host time on that clock (None where the trace lost it)."""

    drift_us: Optional[float] = None

    def stop(self):
        torch = self.torch
        torch.cuda.synchronize()
        self.t_marker2 = time.perf_counter()
        torch.cuda._sleep(1000)
        super().stop()

    def kernels(self) -> List[tuple]:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        marks = sorted(float(e["ts"]) * 1e-6 for e in dev
                       if harness._MARKER in e.get("name", ""))
        if not marks:
            raise RuntimeError("the trace holds no marker kernel")
        offset = self.t_marker - marks[0]
        if len(marks) > 1:
            self.drift_us = 1e6 * (marks[-1] + offset - self.t_marker2)
        return [(e["name"], float(e["ts"]) * 1e-6 + offset,
                 (float(e["ts"]) + float(e.get("dur", 0.0))) * 1e-6 + offset)
                for e in dev if harness._MARKER not in e["name"]]


def trace_window(cell: harness.Cell, seed: int, window_s: float, device,
                 tracer) -> dict:
    """Set-up and one traced window of ``cell`` (as ``run.run_cell`` with
    ``trace``), then the idle time by span, the program spans' totals and
    the per-layer metrics. ``tracer`` stands for ``harness.DeviceTrace``
    (``TiedTrace`` on the card)."""
    traffic = harness.traffic_class(cell)(cell, seed, device)
    traffic.setup()
    tracer.start()
    t0 = time.perf_counter()
    traffic.window(window_s)
    t1 = time.perf_counter()
    tracer.stop()
    traffic.finish()
    window = harness.Window(t0, t1, traffic.spans, traffic.records,
                            cell.config)
    window.kernels = tracer.kernels()
    window.busy_s, _ = harness.busy_and_gaps(window.kernels, t0, t1)
    metrics = {m["name"]: harness.metric_reader(cell, m["name"])(window)
               for m in cell.per_layer}
    program = in_window(window)
    totals: Dict[str, list] = {}
    for n, s, e in program:
        c = totals.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += e - s
    spans = harness.Spans()
    spans.items = list(traffic.spans.items) + program
    named = harness.Window(t0, t1, spans, traffic.records, cell.config,
                           window.kernels, window.busy_s)
    gap_names = tuple(traffic.GAP_SPANS) + tuple(sorted(totals))
    return {"window_s": window.seconds, "busy_s": window.busy_s,
            "requests": len(traffic.records.get("requests") or []),
            "idle_by_span": idle_by_span(named, gap_names),
            "program_spans": totals, "metrics": metrics,
            "clock_drift_us": getattr(tracer, "drift_us", None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from perfbench import run

    run._set_environment()
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("program_spans needs a CUDA device", file=sys.stderr)
        return 2
    out = trace_window(cell, args.seed, args.seconds,
                       torch.device("cuda", 0), TiedTrace(torch))
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
