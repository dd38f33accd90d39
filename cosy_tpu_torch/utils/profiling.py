"""Profiling hooks (the port of the JAX package's ``utils/profiling.py``) on
``torch.profiler``: a trace of a block written as a Chrome / Perfetto JSON
file, named scopes for the stages of a pipeline, and a rolling step timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch

from ..params import resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[str]:
    """Profile the enclosed block: host activity, and the device's kernels
    when ``device`` is CUDA (the default, as for every entry point of the
    port).  Yields the path of the trace, ``<log_dir>/trace.json``, written
    when the block ends (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A named scope of the trace timeline (``record_function``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling step-time statistics over the last ``window`` steps (host
    clock; a step on the card ends in a synchronize for its time to mean
    anything)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(1, len(self.times))
