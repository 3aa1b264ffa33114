"""Tracing / profiling utilities — port of ``dgdm_tpu/core/profiling.py``.

A step timer that logs through the metric sink, ``torch.profiler`` traces
of a training loop's steps (view with TensorBoard's profiler plugin or
``chrome://tracing``), and ``TRACER``, the program's host span recorder.
On a CUDA device the timer synchronises before it reads the clock, so a rate
counts finished work and not work that was only enqueued.

``TRACER.span(name)`` marks where the program does a piece of its work
(``guidance.step``, ``simeval.scenes``, ``pipeline.bake``: dotted names,
module then part). A span reads ``time.perf_counter`` on entry and exit and
holds the difference in ``.seconds`` whether or not the recorder is on; it
never synchronises the device or reads a tensor, so it times the host's
part of the work (for an asynchronous launch, the enqueue). The recorder
keeps ``(name, t0, t1, thread_id)`` between ``TRACER.start()`` and
``TRACER.stop()``, and also while a ``torch.profiler`` session runs (as
``torch.profiler.record_function`` records only then), so that a device
trace always has the program's host spans beside it on one clock.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


class StepTimer:
    """EWMA step timing with throughput accounting."""

    def __init__(self, alpha: float = 0.1,
                 device: Optional[torch.device] = None):
        self.alpha = alpha
        self.device = torch.device(device) if device is not None else None
        self.ewma: Optional[float] = None
        self._t0: Optional[float] = None
        self._rate: Optional[float] = None

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __enter__(self):
        self._t0 = self._now()
        return self

    def __exit__(self, *exc):
        dt = self._now() - self._t0
        self.ewma = dt if self.ewma is None else (
            self.alpha * dt + (1 - self.alpha) * self.ewma
        )
        return False

    def metrics(self, items_per_step: float = 1.0) -> Dict[str, float]:
        if self.ewma is None:
            return {}
        return {
            "perf/step_seconds": self.ewma,
            "perf/items_per_second": items_per_step / self.ewma,
        }

    def tick(self, items: float = 1.0) -> None:
        """Mark the end of one step that processed ``items`` (loop style —
        the first tick only arms the timer)."""
        now = self._now()
        if self._t0 is not None:
            dt = now - self._t0
            rate = items / max(dt, 1e-9)
            self._rate = rate if self._rate is None else (
                self.alpha * rate + (1 - self.alpha) * self._rate
            )
            self.ewma = dt if self.ewma is None else (
                self.alpha * dt + (1 - self.alpha) * self.ewma
            )
        self._t0 = now

    def rate(self) -> float:
        """EWMA items/second seen by tick()."""
        return float(self._rate or 0.0)


def _profiler(log_dir: str) -> "torch.profiler.profile":
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


class TraceWindow:
    """Capture a ``torch.profiler`` trace for steps [start, stop) of a
    training loop — a bounded window after warmup so the trace holds
    steady-state steps. Inert when ``log_dir`` is falsy."""

    def __init__(self, log_dir: Optional[str], start: int = 3, stop: int = 8):
        self.log_dir = log_dir
        self.start, self.stop = start, stop
        self._prof = None

    def step(self, i: int) -> None:
        """Call once per loop step with the global step index."""
        if not self.log_dir:
            return
        if self._prof is None and self.start <= i < self.stop:
            self._prof = _profiler(self.log_dir)
            self._prof.start()
        elif self._prof is not None and i >= self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


class Span:
    """One timed region: ``with TRACER.span(name) as s: ...``, then
    ``s.seconds``."""

    __slots__ = ("_tracer", "name", "t0", "seconds")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        self.seconds = t1 - self.t0
        # PyTorch's own flag of a running torch.profiler session
        if self._tracer.on or getattr(_autograd_profiler,
                                      "_is_profiler_enabled", False):
            self._tracer._record(self.name, self.t0, t1)
        return False


class Tracer:
    """The host span recorder (one per process: ``TRACER``). Spans may nest
    and may be opened from several threads."""

    def __init__(self):
        self.on = False
        self._spans: List[Tuple[str, float, float, int]] = []
        self._lock = threading.Lock()

    def span(self, name: str) -> Span:
        return Span(self, name)

    def traced(self, name: str):
        """Decorator: each call of the function is one span ``name``."""
        def wrap(fn):
            @functools.wraps(fn)
            def traced_fn(*args, **kwargs):
                with Span(self, name):
                    return fn(*args, **kwargs)
            return traced_fn
        return wrap

    def _record(self, name: str, t0: float, t1: float) -> None:
        item = (name, t0, t1, threading.get_ident())
        with self._lock:
            self._spans.append(item)

    def start(self) -> None:
        """Forget the spans recorded so far and record from now on."""
        with self._lock:
            self._spans = []
        self.on = True

    def stop(self) -> List[Tuple[str, float, float, int]]:
        """Stop recording (a running ``torch.profiler`` session still
        records); returns the spans, which stay until the next ``start``."""
        self.on = False
        return self.spans()

    def spans(self) -> List[Tuple[str, float, float, int]]:
        """The spans recorded so far, (name, t0, t1, thread_id) on the
        ``time.perf_counter`` clock, in the order they ended."""
        with self._lock:
            return list(self._spans)


TRACER = Tracer()
