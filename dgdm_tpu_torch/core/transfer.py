"""Host <-> device copies that do not wait on the stream.

A copy from pageable host memory waits for everything queued before it on
the stream, so uploading the next datagen wave's scene would wait for the
running kernel, and ``.cpu()`` on a result would wait for every kernel
queued after it. Here uploads go through page-locked (pinned) memory and
return at once, and results are copied into pinned buffers right after
their launch, with a CUDA event that ``wait`` blocks on alone. On the CPU
both are plain tensors and ``wait`` returns at once.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def upload(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy array (or CPU tensor) -> tensor on ``device``; on CUDA through
    pinned memory, without waiting for the stream."""
    t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                        else a, dtype=dtype)
    if _is_cuda(device):
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def download_async(tensors: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[object]]:
    """Queue copies of device tensors into pinned host buffers on the
    current stream -> (host tensors, event). Read the host tensors only
    after ``wait(event)``."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        return dict(tensors), None
    host = {}
    for k, v in tensors.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def wait(event) -> None:
    if event is not None:
        event.synchronize()


class Stamp:
    """A point in a device's work: a CUDA event recorded on the current
    stream, or the host clock on the CPU (where work is synchronous)."""

    def __init__(self, device):
        if _is_cuda(device):
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.event, self.t = None, time.perf_counter()

    def done(self) -> bool:
        """Whether the device has reached this stamp (at once on the CPU)."""
        return self.event is None or self.event.query()

    def seconds_to(self, later: "Stamp") -> float:
        """Device time from this stamp to ``later``; call after the later
        stamp's work has finished (``wait``)."""
        if self.event is None:
            return later.t - self.t
        later.event.synchronize()
        return self.event.elapsed_time(later.event) / 1e3
