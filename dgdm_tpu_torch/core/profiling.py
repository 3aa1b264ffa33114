"""Tracing / profiling utilities — port of ``dgdm_tpu/core/profiling.py``.

A step timer that logs through the metric sink, and ``torch.profiler``
traces (view with TensorBoard's profiler plugin or ``chrome://tracing``).
On a CUDA device the timer synchronises before it reads the clock, so a rate
counts finished work and not work that was only enqueued.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


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


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace context, written to ``log_dir``."""
    with _profiler(log_dir):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region for profiler timelines."""
    with torch.profiler.record_function(name):
        yield
