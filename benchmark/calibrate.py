"""The readings the limits of ``correct`` are set from, for one cell.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--out FILE]

For each seed it builds the cell's program and drives its checked steps as
a run's set-up does, frees the program and runs the plain reference, and
prints the three numbers of ``benchmark/check.py`` (the lower readings).
For each control seed it also puts in the program's place the reference
computed with float8 products (the precision below the configuration's
bf16: ``reference.kokoro.fp8_cast``) and the reference with half of each
batch left out and the mean taken over the rest (a planted fault), and
prints their numbers against the reference (the upper readings).  A step
that returns its state unchanged reads 1 on ``update_gap`` by the measure
itself and needs no run.  One JSON line per reading; needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import torch

from benchmark import check
from benchmark.reference import kokoro as reference
from benchmark.run import cell, checked_steps, reference_run


def as_program(out: dict, params0: dict, b1: float) -> dict:
    """A reference's result in the shape ``check.numbers`` takes the
    program's."""
    return {"params0": params0, "losses": [x["total"] for x in out["losses"]],
            "first_moment": {k: (1.0 - b1) * v.cpu() for k, v in out["first_grad"].items()},
            "params": {k: v.cpu() for k, v in out["params"].items()}}


def readings(c: dict, seed: int, control: bool, dev: torch.device):
    b1 = c["config"]["training"]["adam_b1"]
    t0 = time.time()
    *_, program, seen = checked_steps(c, seed, dev)
    del program, _
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.time()
    ref = reference_run(c, seed, seen, dev)
    t2 = time.time()
    yield "program", check.numbers(seen, ref, b1), {"setup_s": t1 - t0, "reference_s": t2 - t1}
    if not control:
        return
    for kind, kw in (("control_fp8", {"cast": reference.fp8_cast}),
                     ("fault_half_batch", {"half_batch": True})):
        out = reference_run(c, seed, seen, dev, **kw)
        yield kind, check.numbers(as_program(out, seen["params0"], b1), ref, b1), {}
        del out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control-seeds", default="", help="comma-separated seeds")
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    c = cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in [int(s) for s in args.seeds.split(",")]:
            for kind, found, times in readings(c, seed, seed in controls, torch.device("cuda")):
                line = json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                                   **{k: v["value"] for k, v in found.items()},
                                   "where": found, **times, "card": smi.stdout.strip()})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
