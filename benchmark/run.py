"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell names a configuration
(``benchmark/configs/<name>.json``), a traffic mix
(``benchmark/traffic/<mix>.json``) and its own file
(``benchmark/workloads/<cell>.json``: the limits of the comparison, the
profiled steps, the reference's block of rows); the per-layer metrics are
readers ``benchmark/metrics/<metric>.py``.  Everything is found by the names
in ``BENCHMARK.json``.

A run:

1. set-up: builds the port's training state with weights drawn on the device
   from the seed, makes the traffic, and drives the step through its first
   three steps on the window's own feed, keeping what the comparison needs;
   then warms every shape the cell's traffic uses (a corpus's whole first
   epoch);
2. the window: steps for ``--seconds``, each a call of the port's training
   step on the next batch with the run's generator; with ``--trace 1`` its
   first steps run under ``torch.profiler``;
3. after the window: reads the memory peak, frees the program's state, runs
   the plain reference over the first three steps and compares
   (``benchmark/check.py``); the numbers compared, each beside its limit,
   are the last lines of standard error;
4. prints one JSON line, the last of standard output.

With no card, or fewer cards than the cell asks for, it prints no result and
exits 2; it exits 3 when ``jax``, ``jaxlib``, ``flax`` or ``kokoro_tpu`` are
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import torch

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kokoro_tpu")
CHECKED_STEPS = 3


def process_start() -> float:
    """Wall-clock time this process started (``/proc``), or now."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the harness must not load."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell(name: str, root: Path = REPO) -> dict:
    """Everything a run of cell ``name`` reads, found by name."""
    spec = load_json(root / "BENCHMARK.json")
    wl = next(w for w in spec["workloads"] if w["name"] == name)
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    metrics = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
    end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    return {
        "workload": wl, "config": load_json(root / conf["file"]),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{wl['traffic']}.json"),
        "cell": load_json(BENCH_DIR / "workloads" / f"{name}.json"),
        "end_to_end": end_to_end, "per_layer": metrics,
    }


def reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu().clone() for k, v in tensors.items()}


def checked_steps(c: dict, seed: int, dev: torch.device, fault: Optional[Callable] = None):
    """Set-up's first part: the port's state and the traffic of cell ``c``,
    driven through the checked steps on the window's own call and feed.
    Returns ``(call, steps, feed, program, seen)``: ``seen`` holds what the
    comparison needs (the weights before, the steps' batches and losses,
    the first moments after step one, the weights after the last)."""
    from benchmark import traffic
    from benchmark.program import Program

    conf, mix = c["config"], c["traffic"]
    program = Program(conf, mix.get("training", {}), traffic.derive(seed, "weights"), dev)
    feed = traffic.make_feed(mix, seed, program.model_cfg, program.train_cfg, dev)
    steps = traffic.iterate(feed)
    generator = torch.Generator().manual_seed(traffic.derive(seed, "steps"))
    step = program.step if fault is None else fault(program.step)

    def call(batch):
        return step(program.state, batch, generator)

    seen = {"params0": to_host(program.params()), "losses": [], "batches": []}
    for i in range(CHECKED_STEPS):
        batch, _ = next(steps)
        seen["batches"].append({k: v.detach().cpu().clone() for k, v in batch.items()})
        seen["losses"].append(call(batch)["total"])
        if i == 0:
            seen["first_moment"] = to_host(program.first_moment())
    seen["params"] = to_host(program.params())
    return call, steps, feed, program, seen


def reference_run(c: dict, seed: int, seen: dict, dev: torch.device, **kw) -> dict:
    """The plain reference's steps from ``seen``'s weights over its batches
    (``kw``: ``cast``, ``half_batch``)."""
    from benchmark import traffic
    from benchmark.reference import kokoro as reference

    conf = c["config"]
    t = dict(conf["training"], **c["traffic"].get("training", {}))
    return reference.train({k: v.to(dev) for k, v in seen["params0"].items()},
                           [{k: v.to(dev) for k, v in b.items()} for b in seen["batches"]],
                           traffic.derive(seed, "steps"), conf["model"], t, conf["run"],
                           block_rows=c["cell"]["block_rows"], **kw)


def run(c: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        fault: Optional[Callable] = None, t_start: Optional[float] = None) -> dict:
    """One run of the cell ``c`` (:func:`cell`); the result line's object.
    ``fault`` (tests only) wraps the step: ``fault(step) -> step``."""
    from benchmark import check
    from benchmark.bounds import step_flops
    from benchmark.program import attention_recorder

    t_start = process_start() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    conf, own = c["config"], c["cell"]

    # set-up: the checked steps, then every shape of the traffic
    call, steps, feed, program, seen = checked_steps(c, seed, dev, fault)
    warm = max(own.get("warm_steps", 0), feed.steps_per_epoch() - CHECKED_STEPS)
    for _ in range(warm):
        call(next(steps)[0])
    if trace:  # the profiler's own first starts, in both of the stretch's modes
        from torch.profiler import ProfilerActivity, profile

        device_acts = [ProfilerActivity.CUDA] if cuda else []
        for acts in (device_acts or [ProfilerActivity.CPU], [ProfilerActivity.CPU] + device_acts):
            with profile(activities=acts):
                call(next(steps)[0])
    sync()

    # the window
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    setup_s = t0 - t_start
    attempted = failed = 0
    frames = padded = 0
    collate_s, free = [], {"flops": 0, "steps": 0}
    calls, stretch = [], own.get("profiled_steps", 3) if trace else 0

    def one(free_step: bool):
        nonlocal attempted, failed, frames, padded
        batch, info = next(steps)
        m = call(batch)
        attempted += 1
        failed += int(not (m["stepped"] and m["total"] == m["total"]
                           and abs(m["total"]) != float("inf")))
        frames += info["true_frames"]
        padded += info["padded_frames"]
        if free_step:
            free["flops"] += step_flops(conf["model"], *info["shape"])
            free["steps"] += 1
            if "collate_s" in info:
                collate_s.append(info["collate_s"])

    gaps = []
    if stretch:
        from torch.profiler import record_function

        from benchmark.trace import idle_gaps, summarize

        with attention_recorder(calls), profile(activities=device_acts
                                                or [ProfilerActivity.CPU]) as prof:
            t_s = time.perf_counter()
            for _ in range(stretch):
                one(False)
            sync()
            stretch_s = time.perf_counter() - t_s
        trace_summary = summarize(prof, stretch, stretch_s)
        del prof
        # one more step with the host's operators, for the idle gaps' names
        with profile(activities=[ProfilerActivity.CPU] + device_acts) as prof:
            with record_function("bench.stretch"):
                with record_function("bench.step"):
                    one(False)
                sync()
        gaps = idle_gaps(prof)
        del prof
    t_free = time.time()
    while True:
        one(True)
        if time.time() - t0 >= seconds:
            break
    sync()
    t_end = time.time()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    readings = SimpleNamespace(
        trace=None, calls=calls, peak_bytes=peak, model=conf["model"],
        window={"steps": attempted, "true_frames": frames, "padded_frames": padded,
                "collate_s": collate_s, "free_flops": free["flops"],
                "free_steps": free["steps"], "free_seconds": t_end - t_free})
    if stretch:
        readings.trace = dict(trace_summary, idle_gaps=gaps)
        for x in calls:
            if x["kv_lengths"] is not None:
                x["kv_lengths"] = x["kv_lengths"].tolist()

    # free the program's state before the reference
    del program, steps, feed, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = reference_run(c, seed, seen, dev)
    compared = check.numbers(seen, ref, conf["training"]["adam_b1"])
    correct, lines = check.judge(compared, own["limits"])
    lines.append({"name": "failed_steps", "value": failed, "limit": 0})
    correct = correct and failed == 0

    if trace:
        metrics = {}
        for x in c["per_layer"]:
            value = reader(x["name"])(readings)
            if value is not None:
                metrics[x["name"]] = {"value": value, "unit": x["unit"]}
    else:
        window_s = t_end - t0
        measured = {"train_frames_per_s": frames / window_s, "setup_s": setup_s}
        metrics = {x["name"]: {"value": measured[x["name"]], "unit": x["unit"]}
                   for x in c["end_to_end"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if readings.trace is not None:
        device_info.update(busy_s=readings.trace["busy_s"], window_s=readings.trace["window_s"])
        result["breakdown"] = {"device_ops": readings.trace["device_ops"],
                               "idle_gaps": readings.trace["idle_gaps"]}
    result["checks"] = {x["name"]: {"value": x["value"], "limit": x["limit"]} for x in lines}
    result["compared"] = compared
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description="Run one benchmark cell once on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    c = cell(args.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        result = run(c, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except ForbiddenModules as err:
        print(f"benchmark: modules loaded that the harness must not load: {err}",
              file=sys.stderr)
        return 3
    compared = result.pop("compared")
    print(json.dumps({"compared": compared}), file=sys.stderr)
    for name, x in result["checks"].items():
        print(f"check {name} {x['value']!r} limit {x['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
