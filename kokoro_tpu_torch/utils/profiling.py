"""Profiler traces of the port.

Port of ``kokoro_tpu/utils/profiling.py::trace`` on ``torch.profiler``; the
rest of that module (memory stats, step timing, interbatch phases) is a
later slice (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


def _activities():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def init_profiler() -> None:
    """Start and stop the profiler once, on the calling thread.  The
    profiler's backend initialises on the thread that imported torch; a
    first start from another thread (an HTTP handler's) leaves it
    uninitialised, so a server that will trace from its handlers calls this
    from the main thread first."""
    with torch.profiler.profile(activities=_activities()):
        pass


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Trace the enclosed work, CPU and (when there is a card) CUDA
    activity, into ``logdir/<worker>.<time>.pt.trace.json``: a Chrome trace
    that Perfetto and TensorBoard's profiler plugin open.  Yields the
    ``torch.profiler.profile``."""
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ) as prof:
        yield prof
