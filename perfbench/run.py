"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; ``harness.py`` finds its
files by name. The run needs as many CUDA devices as the cell asks for and
exits with an error, printing no result, where it finds fewer: it never
falls back to the CPU. It drives the PyTorch port ``dgdm_tpu_torch`` only,
and exits with an error if JAX or the JAX package is loaded once the
window has closed.

With ``--trace 0`` the result's metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones, read from a ``torch.profiler``
trace of the window. ``--control`` runs the plain reference in the
program's place in the precision below the configuration's (the check
that the comparison can fail); the benchmark's own runs never pass it.

Build and compile caches stay at fixed paths inside the checkout: the
port's nvcc output in ``dgdm_tpu_torch/_build/``, Triton's, PyTorch's and
CUDA's caches under ``.perfbench_cache/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402


def _set_environment() -> None:
    cache = os.path.join(ROOT, ".perfbench_cache")
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = os.path.join(cache, sub)
    # libraries that would load JAX by themselves
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, control: bool = False, start: float = None,
             log=sys.stderr, tracer=None):
    """One run of ``cell`` on ``device``: returns the result dict, or None
    where a forbidden module was loaded. Callers that are not the command
    line (tests) may pass a CPU device, and with it a ``tracer`` that
    stands for ``harness.DeviceTrace``."""
    import torch

    start = harness.process_start_time() if start is None else start
    traffic = harness.traffic_class(cell)(cell, seed, device, control=control)
    traffic.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.time() - start
    if trace and tracer is None and cuda:
        tracer = harness.DeviceTrace(torch)
    if not trace:
        tracer = None
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    traffic.window(seconds)
    t1 = time.perf_counter()
    if tracer is not None:
        tracer.stop()
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=log)
        return None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traffic.finish()
    window = harness.Window(t0, t1, traffic.spans, traffic.records, cell.config)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(device) if cuda
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {}
    if trace:
        if tracer is not None:
            window.kernels = tracer.kernels()
            window.busy_s, _ = harness.busy_and_gaps(window.kernels, t0, t1)
            dev["busy_s"] = window.busy_s
            dev["window_s"] = window.seconds
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(cell, m["name"])(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if window.kernels is not None:
            result["breakdown"] = harness.breakdown(window, traffic.GAP_SPANS)
    else:
        values = dict(traffic.end_to_end(window), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    numbers = traffic.compare()
    correct, lines = harness.judge(numbers, cell.limits)
    for line in traffic.report_lines() + lines:
        print(line, file=log)
    out = {"correct": correct, "attempted": traffic.attempted,
           "failed": traffic.failed, "metrics": metrics, "device": dev}
    out.update(result)
    out["compared"] = {k: {"value": v, "limit": cell.limits[k]}
                       for k, v in numbers.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    _set_environment()
    cell = harness.load_cell(args.workload)

    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), control=args.control)
    if out is None:
        return 1
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
