"""Reading ``torch.profiler`` traces of the profiled stretch.

The stretch is traced twice over:

* its steps with the device's activities alone (kernels, copies, fills), so
  that the profiler adds little host time to them: the busy time (the union
  of the activities' intervals) against the stretch's length on the host
  clock, the kernels by name and their launches a step;
* one more step with the host's operators too, wrapped in the span
  ``bench.stretch``: the idle gaps between the device's activities there,
  each named by the innermost host span open at its middle (an operator, or
  the harness's span ``bench.step`` when the host was in Python between
  operators).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List

STRETCH = "bench.stretch"
STEP = "bench.step"
GAP_LABEL_MIN_US = 20.0  # shorter gaps are summed under one name
TOP = 10


def _device(events) -> List[tuple]:
    """(start us, end us, name) of the device's activities, without the
    harness's spans that the profiler mirrors on the device's timeline."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not (getattr(e, "is_user_annotation", False)
                           or e.name in (STRETCH, STEP)))


def _merge(intervals) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b, _ in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def summarize(prof, steps: int, window_s: float) -> Dict:
    """The stretch's numbers from its device-only trace: ``window_s`` (the
    host clock's), ``busy_s``, ``kernels`` (name, seconds) of every kernel
    launch, ``launches`` a step and the breakdown's ``device_ops``."""
    device = _device(prof.events())
    busy = sum(b - a for a, b in _merge(device)) * 1e-6
    kernels = [(n, (b - a) * 1e-6) for a, b, n in device if is_kernel(n)]
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, n in device:
        by_name[n] += (b - a) * 1e-6
    return {
        "window_s": window_s, "busy_s": busy, "kernels": kernels,
        "launches": len(kernels) / max(steps, 1),
        "device_ops": sorted(([n[:160], s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:TOP],
    }


def idle_gaps(prof) -> List[list]:
    """Idle seconds of the ``bench.stretch`` span of a trace with the host's
    operators, summed by the innermost host span open at each gap's middle
    (the latest-starting span that contains it)."""
    from torch.autograd import DeviceType

    host, stretch = [], None
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            host.append((e.time_range.start, e.time_range.end, e.name))
            if e.name == STRETCH:
                stretch = (e.time_range.start, e.time_range.end)
    if stretch is None:
        return []
    s0, s1 = stretch
    device = [(max(a, s0), min(b, s1), n) for a, b, n in _device(prof.events())
              if b > s0 and a < s1]
    edges = [s0] + [x for ab in _merge(device) for x in ab] + [s1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    totals: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b - a < GAP_LABEL_MIN_US:
            totals[f"gaps under {GAP_LABEL_MIN_US:g} us"] += (b - a) * 1e-6
            continue
        mid = 0.5 * (a + b)
        label = "no host span"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 20000, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        totals[label[:160]] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in totals.items()), key=lambda x: -x[1])[:TOP]
