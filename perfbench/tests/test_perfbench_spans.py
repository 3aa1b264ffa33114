"""The program's spans in the benchmark (``perfbench/program_spans.py`` and
the readers ``verify_scene_ms``, ``finger_build_ms``, ``guidance_step_ms``):
the readers on a synthetic window, None where it holds no such span; a
traced run on the CPU, where a ``torch.profiler`` session over the window
stands for the card's trace, reports them, and a run with ``--trace 0`` or
``--control`` leaves the recorder empty; an idle gap is named after the
innermost span that held the host, the program's inside the benchmark's."""

import time

import pytest
import torch

from dgdm_tpu_torch.core.profiling import TRACER
from perfbench import harness, program_spans, run
from perfbench.tests import small

NEW = ("verify_scene_ms", "finger_build_ms", "guidance_step_ms")


@pytest.fixture
def empty_tracer():
    TRACER.start()
    TRACER.stop()
    yield TRACER
    TRACER.start()
    TRACER.stop()


def _reader(name):
    return harness.metric_reader(harness.load_cell("dgdm-2d.design"), name)


def _window(requests=2):
    return harness.Window(100.0, 110.0, harness.Spans(),
                          {"requests": [{}] * requests}, {})


def test_readers_on_a_synthetic_window(empty_tracer):
    window = _window()
    for name in NEW:
        assert _reader(name)(window) is None, name
    TRACER.start()
    items = [("simeval.scenes", 101.0, 101.4), ("scene.fingers", 101.0, 101.3),
             ("simeval.arrays", 101.4, 101.5), ("simeval.rollout", 101.5, 101.6),
             ("simeval.scenes", 105.0, 105.2), ("scene.fingers", 105.0, 105.1),
             ("guidance.step", 102.0, 102.02), ("guidance.step", 103.0, 103.04),
             # outside the window: warm-up and the comparison
             ("simeval.scenes", 99.0, 99.5), ("guidance.step", 110.5, 111.0)]
    for n, s, e in items:
        TRACER._record(n, s, e)
    TRACER.stop()
    assert _reader("verify_scene_ms")(window) == pytest.approx(
        1e3 * (0.4 + 0.1 + 0.2) / 2)
    assert _reader("finger_build_ms")(window) == pytest.approx(
        1e3 * (0.3 + 0.1) / 2)
    assert _reader("guidance_step_ms")(window) == pytest.approx(30.0)
    assert _reader("verify_scene_ms")(_window(requests=0)) is None


def test_idle_gap_named_after_the_innermost_program_span():
    spans = harness.Spans()
    spans.items = [("verify_host", 0.0, 10.0), ("simeval.scenes", 1.0, 4.0),
                   ("scene.fingers", 1.5, 2.5), ("guidance", 10.0, 12.0)]
    window = harness.Window(0.0, 12.0, spans, {}, {},
                            kernels=[("k", 0.0, 1.2), ("k", 2.6, 3.0),
                                     ("k", 4.0, 9.0), ("k", 9.5, 10.5),
                                     ("k", 11.0, 12.0)])
    names = ("guidance", "verify_host", "objectives", "scene.fingers",
             "simeval.scenes")
    idle = program_spans.idle_by_span(window, names)
    assert idle == pytest.approx({"scene.fingers": 1.4, "simeval.scenes": 1.0,
                                  "verify_host": 0.5, "guidance": 0.5})


class ProfiledStandIn:
    """Stands for ``harness.DeviceTrace`` on the CPU: a ``torch.profiler``
    session (host activity) over the window, and one kernel in it."""

    def start(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def kernels(self):
        d = self.t1 - self.t0
        return [("rollout2d_kernel<16, 0>", self.t0 + 0.1 * d,
                 self.t0 + 0.4 * d)]


def test_traced_run_reports_the_program_spans(empty_tracer):
    cell = small.design_cell()
    out = run.run_cell(cell, 2 ** 31 + 23, 1.0, True, small.CPU,
                       tracer=ProfiledStandIn())
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(m)
    assert 0.0 < m["finger_build_ms"] < m["verify_scene_ms"]
    assert m["guidance_step_ms"] > 0.0
    names = {s[0] for s in TRACER.spans()}
    assert {"guidance.step", "guidance.eps", "guidance.grad",
            "simeval.scenes", "scene.fingers", "simeval.fetch"} <= names


@pytest.mark.parametrize("control", [False, True])
def test_untraced_and_control_runs_leave_the_recorder_empty(empty_tracer,
                                                           control):
    cell = small.design_cell()
    out = run.run_cell(cell, 2 ** 31 + 29, 0.5, False, small.CPU,
                       control=control)
    assert not set(NEW) & set(out["metrics"])
    assert TRACER.spans() == []


def test_trace_window_names_the_idle_time(empty_tracer):
    out = program_spans.trace_window(small.design_cell(), 2 ** 31 + 31, 1.0,
                                     small.CPU, ProfiledStandIn())
    assert out["requests"] >= 1
    steps = small.design_cell().config["num_inference_steps"]
    assert out["program_spans"]["guidance.step"][0] == out["requests"] * steps
    idle = out["idle_by_span"]
    assert sum(idle.values()) == pytest.approx(
        out["window_s"] - out["busy_s"])
    assert any("." in name for name in idle)
    assert out["metrics"]["finger_build_ms"] > 0.0
    assert out["clock_drift_us"] is None


@pytest.mark.cuda
def test_tied_trace_on_the_card(cuda_device):
    tracer = program_spans.TiedTrace(torch)
    tracer.start()
    x = torch.randn(512, 512, device=cuda_device)
    (x @ x).sum().item()
    tracer.stop()
    kernels = tracer.kernels()
    assert kernels and not any(harness._MARKER in n for n, _, _ in kernels)
    assert all(tracer.t_marker <= s <= e <= tracer.t_marker2 + 0.01
               for _, s, e in kernels)
    assert tracer.drift_us is not None
