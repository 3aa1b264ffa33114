"""The port's host span recorder (``dgdm_tpu_torch/core/profiling.TRACER``)
and the spans the program opens where it does its work, on the CPU:

- the recorder: a span off records nothing but still gives ``.seconds``;
  ``start``/``stop`` clear and return; nested spans come back in the order
  they ended; spans from a thread pool are all kept; a running
  ``torch.profiler`` session records; a span never synchronises the device
  or reads a tensor;
- ``sim_eval_batch_2d`` opens each ``simeval.*`` span once per object, with
  its 2 x B finger builds under B ``scene.fingers`` spans, and gives the
  same outputs bit for bit with the recorder on and off;
- ``GuidedSampler2D.sample_sweep`` opens one ``guidance.step`` span a DDIM
  step, each holding one ``guidance.eps`` and one ``guidance.grad``;
- ``pipeline_2d``'s summary seconds are its ``pipeline.*`` spans'."""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.design.guidance import GuidedSampler2D
from dgdm_tpu_torch.eval.simeval import sim_eval_batch_2d
from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
from dgdm_tpu_torch.sim import engine2d, pipeline
from tests import torch_parity  # noqa: F401  (one torch thread)


@pytest.fixture
def tracer():
    """TRACER recording for the test, off and empty after it."""
    TRACER.start()
    try:
        yield TRACER
    finally:
        TRACER.stop()
        TRACER.start()
        TRACER.stop()


def _names(spans):
    return [s[0] for s in spans]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_records_nothing_but_times():
    TRACER.start()
    TRACER.stop()
    with TRACER.span("test.off") as span:
        time.sleep(0.002)
    assert span.seconds >= 0.002
    assert TRACER.spans() == []


def test_start_clears_and_stop_returns(tracer):
    with tracer.span("test.a"):
        pass
    first = tracer.stop()
    assert _names(first) == ["test.a"]
    with tracer.span("test.off"):
        pass
    assert _names(tracer.spans()) == ["test.a"]
    tracer.start()
    assert tracer.spans() == []
    with tracer.span("test.b") as span:
        pass
    (name, t0, t1, tid), = tracer.stop()
    assert (name, tid) == ("test.b", threading.get_ident())
    assert t1 - t0 == span.seconds >= 0.0


def test_nested_spans_in_order(tracer):
    with tracer.span("test.outer"):
        with tracer.span("test.inner"):
            pass
        with tracer.span("test.inner2"):
            pass

    @tracer.traced("test.fn")
    def fn(x):
        return 2 * x

    assert fn(3) == 6 and fn.__name__ == "fn"
    spans = tracer.stop()
    assert _names(spans) == ["test.inner", "test.inner2", "test.outer",
                             "test.fn"]
    assert _inside(spans[0], spans[2]) and _inside(spans[1], spans[2])
    assert spans[0][2] <= spans[1][1]


def test_thread_pool_spans_all_kept(tracer):
    """More workers than cores, a short switch interval: no span is lost
    to a race on the list."""
    per, workers = 200, 16

    def work(i):
        for _ in range(per):
            with tracer.span("test.thread"):
                pass
        return threading.get_ident()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            tids = set(pool.map(work, range(workers)))
    finally:
        sys.setswitchinterval(old)
    spans = tracer.stop()
    assert len(spans) == per * workers
    assert {s[3] for s in spans} == tids


def test_profiler_session_records():
    TRACER.start()
    TRACER.stop()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with TRACER.span("test.profiled"):
            pass
    with TRACER.span("test.after"):
        pass
    assert _names(TRACER.spans()) == ["test.profiled"]
    TRACER.start()
    TRACER.stop()


def test_span_never_synchronises(tracer):
    def refuse(*a, **kw):
        raise AssertionError("a span touched the device")

    with mock.patch.object(torch.cuda, "synchronize", refuse), \
            mock.patch.object(torch.Tensor, "item", refuse), \
            mock.patch.object(torch.Tensor, "cpu", refuse), \
            mock.patch.object(torch.profiler, "record_function", refuse):
        with tracer.span("test.bare") as span:
            pass
    assert span.seconds >= 0.0
    assert _names(tracer.stop()) == ["test.bare"]


def test_sim_eval_batch_2d_spans(tracer):
    b = 2
    contour = extract_contours(synthetic_icon(0))
    pts = np.random.RandomState(3).uniform(-0.5, 0.5, (b, 14)) \
        .astype(np.float32)
    kw = dict(num_rot=8, total_steps=300, regrasp_every=150, device="cpu")
    builds = []
    real = engine2d._finger_host_work_2d

    def counted(y):
        t0 = time.perf_counter()
        out = real(y)
        builds.append((t0, time.perf_counter()))
        return out

    with mock.patch.object(engine2d, "_finger_host_work_2d", counted):
        on = sim_eval_batch_2d(pts, [contour], **kw)
    spans = tracer.stop()
    off = sim_eval_batch_2d(pts, [contour], **kw)
    assert tracer.spans() == spans
    names = _names(spans)
    for name in ("simeval.scenes", "simeval.arrays", "simeval.rollout",
                 "simeval.fetch", "simeval.metrics"):
        assert names.count(name) == 1, name
    order = [n for n in names if n.startswith("simeval.")]
    assert order == ["simeval.scenes", "simeval.arrays", "simeval.rollout",
                     "simeval.fetch", "simeval.metrics"]
    fingers = [s for s in spans if s[0] == "scene.fingers"]
    objects = [s for s in spans if s[0] == "scene.object"]
    scenes = next(s for s in spans if s[0] == "simeval.scenes")
    assert len(fingers) == len(objects) == b and len(builds) == 2 * b
    for s in fingers + objects:
        assert _inside(s, scenes)
    for t0, t1 in builds:
        assert sum(s[1] <= t0 and t1 <= s[2] for s in fingers) == 1
    assert max(np.abs(m["delta_theta"]).max() for m in on) > 1e-2
    assert len(on) == len(off) == b
    for m_on, m_off in zip(on, off):
        assert m_on.keys() == m_off.keys()
        for k in m_on:
            np.testing.assert_array_equal(m_on[k], m_off[k], err_msg=k)


def test_sample_sweep_step_spans(tracer):
    torch.manual_seed(0)
    unet = ConditionalUnet1D(down_dims=(16, 32))
    cls = ProfileForward2D(width=32, num_trunk=2, object_ch=20)
    sampler = GuidedSampler2D(unet, cls, grid_size=4, num_pos=1,
                              device="cpu")
    obj = np.random.RandomState(0).uniform(-1, 1, (1, 20)).astype(np.float32)
    noise = np.random.RandomState(1).randn(2, 14, 1).astype(np.float32)
    inputs = sampler.sweep_inputs(["rotate"], obj, False)
    out = sampler.sample_sweep(noise, *inputs[:4])
    spans = tracer.stop()
    assert out.shape == (1, 2, 14, 1)
    steps = [s for s in spans if s[0] == "guidance.step"]
    assert len(steps) == sampler.num_inference_steps
    assert _names(spans).count("guidance.inputs") == 2
    for part in ("guidance.eps", "guidance.grad"):
        parts = [s for s in spans if s[0] == part]
        assert len(parts) == len(steps)
        for st in steps:
            assert sum(_inside(p, st) for p in parts) == 1, part


def test_pipeline_2d_seconds_are_its_spans(tracer, tmp_path):
    objects = [(oi, extract_contours(synthetic_icon(oi))) for oi in (0, 1)]
    summary = pipeline.pipeline_2d(objects, [0, 1], str(tmp_path),
                                   grid_size=4, num_pos=1, device="cpu")
    spans = tracer.stop()

    def seconds(name):
        return [t1 - t0 for n, t0, t1, _ in spans if n == name]

    assert summary["waves"] == len(seconds("pipeline.bake")) == 2
    assert len(seconds("pipeline.launch")) == len(seconds("pipeline.drain")) \
        == 2
    assert len(seconds("pipeline.write")) == 4
    assert summary["bake_s"] == sum(seconds("pipeline.bake"))
    assert summary["wait_s"] == sum(seconds("pipeline.drain"))
    assert summary["write_s"] == pytest.approx(
        sum(seconds("pipeline.write")), rel=1e-12)
    writers = {tid for n, _, _, tid in spans if n == "pipeline.write"}
    assert threading.get_ident() not in writers
