"""The port's spans (``kokoro_tpu_torch/utils/profiling.py``) against the
device's timeline: a stretch of steps traced with the host's and the
device's activities together, read into numbers a step of the training
step's phases and the data path.

Each device activity (kernel, copy, fill) is tied to its launch by
correlation id: the CUDA runtime call with the activity's own id, else the
host operator the activity is linked to.  It is put down to the innermost
``kokoro.*`` span whose host interval holds the launch's time, on any host
thread (``torch.autograd.grad`` launches the backward from the autograd
engine's device thread, outside the caller's chain of operators).  Spans
sit on one timeline with the activities (the profiler's clock), so the
device's idle intervals fall inside host spans too.

Numbers a step (the stretch's ``kokoro.train_step`` spans):

* ``fwd_ms``, ``bwd_ms``, ``optimizer_ms``: device ms of the activities
  launched inside ``kokoro.forward``, ``kokoro.backward``,
  ``kokoro.optimizer``;
* ``host_read_idle_ms``: device idle ms from the drain that
  ``kokoro.host_read`` waits for to the start of the first activity launched
  after it ends;
* ``data_wait_ms``: the same for ``kokoro.plan`` and ``kokoro.collate``:
  device idle ms from the end of what was launched before the data path
  ends to the start of the first activity launched after it (none where no
  batch is collated in the stretch).

Both idle numbers are read on the device's timestamps alone: in the H100's
traces a kernel's start read 0.3-1.1 ms earlier than its own launch, so an
idle interval cut at a host span's ends would be off by that much.

Beside them, :func:`measure` reads the port's counters over the stretch
(``utils/profiling.py::counters``, reset at its start): ``collate``'s true
over padded frames and the attention entries' calls a step by shape, the
program's own copies of what ``padding_eff`` and the rooflines take from
the harness today.  A program without the counters gives none.

    python3 -m benchmark.spans --workload <cell> --seed <n> [--steps K]

runs a cell's set-up as ``benchmark/run.py`` does, its device-only stretch,
then this stretch and as many steps unprofiled; prints the numbers, the
breakdown by span and the counters beside the harness's own frames and
attention calls as one JSON line (no comparison, no result line).  This
command is a second copy of ``run.py``'s set-up: it goes when a
``benchmark`` change calls :func:`measure` and :func:`describe` from
``run.py``, which keep.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional

from benchmark import trace

PREFIX = "kokoro."
STEP = "kokoro.train_step"
PHASES = {"fwd_ms": "kokoro.forward", "bwd_ms": "kokoro.backward",
          "optimizer_ms": "kokoro.optimizer"}
HOST_READ = "kokoro.host_read"
DATA = ("kokoro.plan", "kokoro.collate")
MIN_STEPS = 4


class Event:
    """What this module reads of a profiler event; tests build them by hand.
    ``device``: a device activity; ``corr``: its correlation id (the
    profiler's ``id``), ``linked``: the host operator it is linked to."""

    __slots__ = ("name", "start", "end", "thread", "device", "corr", "linked")

    def __init__(self, name: str, start: float, end: float, thread: int = 0,
                 device: bool = False, corr: int = 0, linked: int = 0):
        self.name, self.start, self.end, self.thread = name, start, end, thread
        self.device, self.corr, self.linked = device, corr, linked


def events_of(prof) -> List[Event]:
    """A ``torch.profiler`` session's events, the harness's spans and the
    profiler's user annotations left out of the device's activities."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        device = e.device_type == DeviceType.CUDA
        if device and (getattr(e, "is_user_annotation", False) or e.name.startswith(
                (PREFIX, "bench."))):
            continue
        out.append(Event(e.name, e.time_range.start, e.time_range.end, e.thread, device,
                         e.id, getattr(e, "linked_correlation_id", 0) or 0))
    return out


def _launches(events: List[Event]) -> Dict[int, float]:
    """Host time of each device activity's launch, by the activity's index."""
    runtime, ops = {}, {}
    for e in events:
        if e.device:
            continue
        if e.name.startswith("cu"):  # runtime and driver calls share the activity's id
            runtime[e.corr] = e.start
        elif e.corr:
            ops.setdefault(e.corr, e.start)
    out = {}
    for i, e in enumerate(events):
        if not e.device:
            continue
        t = runtime.get(e.corr)
        if t is None:
            t = ops.get(e.linked)
        if t is not None:
            out[i] = t
    return out


class _Spans:
    """The ``kokoro.*`` spans of all threads, for innermost-span lookups."""

    def __init__(self, events: List[Event]):
        # outer before inner where two start together
        self.spans = sorted(((e.start, e.end, e.name) for e in events
                             if not e.device and e.name.startswith(PREFIX)),
                            key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def innermost(self, t: float) -> Optional[str]:
        """The latest-starting span that holds ``t``."""
        for j in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[j][1] >= t:
                return self.spans[j][2]
        return None

    def of(self, name: str) -> "_Intervals":
        return _Intervals([(a, b) for a, b, n in self.spans if n == name])


class _Intervals(list):
    """One span's intervals, in order and disjoint (a span does not nest in
    itself)."""

    def __init__(self, intervals):
        super().__init__(intervals)
        self.starts = [a for a, _ in self]

    def __contains__(self, t) -> bool:
        j = bisect.bisect_right(self.starts, t) - 1
        return j >= 0 and self[j][1] >= t


def _merge(intervals) -> List[List[float]]:
    return trace._merge(sorted((a, b, None) for a, b in intervals))


def _idle(busy: List[List[float]], a: float, b: float) -> float:
    """Microseconds of [a, b] that no merged busy interval covers."""
    if b <= a:
        return 0.0
    covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
    return (b - a) - covered


class _Gaps:
    """The device's idle gap that a host interval leaves: from the end of
    the last activity launched before the interval ends (the drain of what
    was queued) to the start of the first launched after it.  Both ends are
    device timestamps, so an offset between the host's and the device's
    clocks in the trace drops out."""

    def __init__(self, launch: Dict[int, float], device, busy):
        self.order = sorted((launch[i], e.start, e.end) for i, e in device if i in launch)
        self.launched = [t for t, _, _ in self.order]
        self.drained, last = [], float("-inf")
        for _, _, end in self.order:
            last = max(last, end)
            self.drained.append(last)
        self.busy = busy

    def idle(self, intervals) -> float:
        """Idle microseconds of the gaps the host intervals leave, each gap
        once however many intervals end in it."""
        gaps = {bisect.bisect_right(self.launched, b) for _, b in intervals}
        return sum(_idle(self.busy, self.drained[j - 1], self.order[j][1])
                   for j in gaps if 0 < j < len(self.order))


def category(name: str) -> str:
    """A device activity's kind, for the breakdown."""
    if not trace.is_kernel(name) or "copy_kernel" in name:
        return "copy"
    if "reduce_kernel" in name:
        return "reduction"
    if "elementwise_kernel" in name or "multi_tensor_apply" in name:
        return "elementwise"
    if "kokoro_attn" in name:
        return "attention"
    return "other"


def read(events: List[Event]) -> Dict:
    """The numbers a step of one stretch, and the breakdown by span."""
    spans = _Spans(events)
    steps = len(spans.of(STEP))
    if not steps:
        return {}
    launch = _launches(events)
    device = [(i, e) for i, e in enumerate(events) if e.device]
    busy = _merge((e.start, e.end) for _, e in device)
    phase_spans = {k: spans.of(n) for k, n in PHASES.items()}
    step_spans = spans.of(STEP)
    totals = dict.fromkeys(PHASES, 0.0)
    in_step = unattributed = 0.0
    by_span: Dict[str, Dict] = defaultdict(lambda: {"launches": 0, "ms": 0.0})
    kinds: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for i, e in device:
        us = e.end - e.start
        t = launch.get(i)
        if t is None:
            unattributed += us
            continue
        inner = spans.innermost(t) or "(no span)"
        by_span[inner]["ms"] += us
        by_span[inner]["launches"] += int(trace.is_kernel(e.name))
        if t in step_spans:
            in_step += us
        for key, intervals in phase_spans.items():
            if t in intervals:
                totals[key] += us
                kinds[key][category(e.name)] += us
                break
    out = {k: v * 1e-3 / steps for k, v in totals.items()}
    gap = _Gaps(launch, device, busy)
    reads = spans.of(HOST_READ)
    if reads:
        out["host_read_idle_ms"] = gap.idle(reads) * 1e-3 / steps
    data = _merge(iv for name in DATA for iv in spans.of(name))
    if data:
        out["data_wait_ms"] = gap.idle(data) * 1e-3 / steps
    phased = sum(totals.values())
    out["breakdown"] = {
        "steps": steps,
        "phase_share_of_step": phased / in_step if in_step else None,
        "unattributed_ms": unattributed * 1e-3 / steps,
        "by_span": {n: {"launches": v["launches"] / steps, "ms": v["ms"] * 1e-3 / steps}
                    for n, v in sorted(by_span.items(), key=lambda kv: -kv[1]["ms"])},
        "kinds": {k: {c: us / totals[k] for c, us in sorted(v.items(), key=lambda x: -x[1])}
                  for k, v in kinds.items() if totals[k]},
    }
    return out


def _port_counters():
    """``(counters, reset_counters)`` of the port, or None where it has none."""
    try:
        from kokoro_tpu_torch.utils import profiling
    except ImportError:
        return None
    both = getattr(profiling, "counters", None), getattr(profiling, "reset_counters", None)
    return both if all(both) else None


def attention_key(kind, B, T, H, Dh, dtype, causal, grad) -> str:
    return f"{kind} B={B} T={T} H={H} Dh={Dh} {dtype} causal={causal} grad={grad}"


def tally(snapshot: Dict, steps: int) -> Dict:
    """The counters' snapshot of a stretch: ``padding_eff`` (%, true over
    padded frames; None where nothing was collated), ``batches`` and the
    attention calls a step by shape."""
    padded = snapshot["frames_padded"]
    return {"padding_eff": 100.0 * snapshot["frames_true"] / padded if padded else None,
            "batches": snapshot["batches"],
            "attention_calls": {attention_key(*k): n / steps
                                for k, n in sorted(snapshot["attention"].items(), key=str)}}


def measure(one, steps: int, sync, device_acts: list) -> Dict:
    """``steps`` calls of ``one()`` (a step with its batch) under a profiler
    with the host's and the device's activities; their numbers
    (:func:`read`), the stretch's host seconds a step and, where the port
    has counters, their :func:`tally` as ``counts``."""
    from torch.profiler import ProfilerActivity, profile

    port = _port_counters()
    if port:
        port[1]()
    with profile(activities=[ProfilerActivity.CPU] + device_acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        sync()
        seconds = time.perf_counter() - t0
    out = read(events_of(prof))
    out["stretch_ms_per_step"] = 1e3 * seconds / steps
    if port:
        out["counts"] = tally(port[0](), steps)
    return out


def describe(numbers: Dict) -> List[str]:
    """Lines for standard error: launches and device ms a step by span, and
    each phase's share by kind of kernel."""
    b = numbers.get("breakdown")
    if not b:
        return []
    lines = [f"spans: {b['steps']} steps; phases cover {b['phase_share_of_step']!r} of the "
             f"step's device time; {b['unattributed_ms']:.3f} ms a step unattributed"]
    for name, v in b["by_span"].items():
        lines.append(f"span {name}: {v['launches']:.1f} launches, {v['ms']:.3f} ms a step")
    for phase, shares in b["kinds"].items():
        lines.append(f"kinds {phase}: " + ", ".join(f"{c} {100 * s:.1f} %"
                                                    for c, s in shares.items()))
    counts = numbers.get("counts")
    if counts:
        lines.append(f"counts: padding_eff {counts['padding_eff']!r} % over "
                     f"{counts['batches']} batches")
        for key, n in counts["attention_calls"].items():
            lines.append(f"attention {key}: {n:.2f} calls a step")
    return lines


def main(argv=None) -> int:
    import torch

    from benchmark.program import attention_recorder
    from benchmark.run import CHECKED_STEPS, cell, checked_steps

    p = argparse.ArgumentParser(description="Trace one cell's steps with the port's spans.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=0,
                   help="default: the cell's profiled steps, at least 4")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    c = cell(args.workload)
    dev = torch.device("cuda")
    call, steps, feed, program, _ = checked_steps(c, args.seed, dev)
    for _ in range(max(c["cell"].get("warm_steps", 0), feed.steps_per_epoch() - CHECKED_STEPS)):
        call(next(steps)[0])
    acts = [ProfilerActivity.CUDA]
    for modes in (acts, [ProfilerActivity.CPU] + acts):
        with profile(activities=modes):
            call(next(steps)[0])
    torch.cuda.synchronize()
    profiled = c["cell"].get("profiled_steps", 3)
    n = args.steps or max(MIN_STEPS, profiled)

    frames = [0, 0]

    def one():
        batch, info = next(steps)
        frames[0] += info["true_frames"]
        frames[1] += info["padded_frames"]
        call(batch)

    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            one()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    device_only = trace.summarize(prof, profiled, seconds)
    device_only["spans"] = sum(e.name.startswith(PREFIX) for e in prof.events())
    device_only["spans_read"] = sum(name.startswith(PREFIX)
                                    for *_, name in trace._device(prof.events()))
    del prof
    calls = []
    frames[:] = [0, 0]
    with attention_recorder(calls):
        numbers = measure(one, n, torch.cuda.synchronize, acts)
    recorded = Counter(attention_key(x["kind"], x["B"], x["T"], x["H"], x["Dh"], x["dtype"],
                                     x["causal"], x["grad"]) for x in calls)
    numbers["harness"] = {"padding_eff": 100.0 * frames[0] / frames[1],
                          "attention_calls": {k: v / n for k, v in sorted(recorded.items())}}
    t0 = time.perf_counter()
    for _ in range(n):
        one()
    torch.cuda.synchronize()
    numbers["unprofiled_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / n
    numbers["device_only"] = {"busy_ms_per_step": 1e3 * device_only["busy_s"] / profiled,
                              "launches": device_only["launches"],
                              "window_ms_per_step": 1e3 * device_only["window_s"] / profiled,
                              "spans": device_only["spans"],
                              "spans_read": device_only["spans_read"]}
    for line in describe(numbers):
        print(line, file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "steps": n, **numbers}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
