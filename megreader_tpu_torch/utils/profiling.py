"""Profiling helpers on ``torch.profiler``.

``trace(log_dir)``: a context manager that records host (CPU) and device
(CUDA, where the build has it) activity and writes one Chrome/Perfetto trace
file, ``<log_dir>/trace_<pid>_<n>.json``, when it exits.
``annotate(name)``: a named region that shows up in that trace.
``StepTimer``: wall-clock time of each step; ``stop(sync)`` first waits for
the device of a CUDA tensor in ``sync``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Any, Iterator, List, Optional

import torch

_count = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[torch.profiler.profile]:
    """Record the block; the trace file's path is ``profiler.trace_path``
    once the block has exited. ``create_perfetto_link`` prints that path for
    ui.perfetto.dev (which opens it from the disk)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_count)}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = path
    with prof:
        yield prof
    prof.export_chrome_trace(path)
    if create_perfetto_link:
        print(f"trace written to {path}: open it at https://ui.perfetto.dev")


def annotate(name: str) -> torch.profiler.record_function:
    """A named region that shows up in traces."""
    return torch.profiler.record_function(name)


def _cuda_devices(x: Any) -> List[torch.device]:
    if isinstance(x, torch.Tensor):
        return [x.device] if x.device.type == "cuda" else []
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [d for v in x for d in _cuda_devices(v)]
    return []


class StepTimer:
    """Per-step wall-clock timer that waits for the device of its result."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_array: Any = None) -> float:
        """Seconds since ``start``, after synchronising the device of every
        CUDA tensor in ``sync_array`` (a tensor, or lists, tuples and dicts
        of them)."""
        for dev in dict.fromkeys(_cuda_devices(sync_array)):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def percentile(self, p: float) -> float:
        if not self.times:
            return 0.0
        xs = sorted(self.times)
        return xs[min(int(len(xs) * p / 100.0), len(xs) - 1)]

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)
