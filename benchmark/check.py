"""The comparison that decides ``correct``.

The program's first three steps of the run (set-up drives them through the
window's own call and feed) against the plain reference's three steps from
the same weights, batches and step seeds:

* ``loss_gap``: the largest relative gap of a step's total loss;
* ``grad_gap``: the first step's gradient as the optimizer took it, worked
  out from the program's first moments after that step (``mu / (1 - b1)``),
  leaf by leaf: the gap between the program's norm and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf; the worst leaf;
* ``update_gap``: the same of each leaf's change over the three steps.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's move by round-off alone under Adam and are left out of it;
* ``grad_gap_median``, ``update_gap_median``: the median leaf's gap of each.

The cell's file says which of them are held to a limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

ROUNDOFF_SHARE = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's (inf where not finite)."""
    median = statistics.median(reference.values())
    gaps = {}
    for k, r in reference.items():
        gap = abs(program[k] - r) / max(r, median, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def worst_and_median(gaps: Dict[str, float]) -> Tuple[float, str, float]:
    name = max(gaps, key=gaps.get)
    return gaps[name], name, statistics.median(gaps.values())


def numbers(program: dict, reference: dict, b1: float) -> Dict[str, dict]:
    """``{name: {"value", "leaf"/"step"}}`` of the three numbers.  ``program``
    holds ``losses`` (the steps' totals), ``params0``, ``first_moment`` (after
    step one) and ``params`` (after the last step), host tensors by name;
    ``reference`` is ``reference.kokoro.train``'s result."""
    gaps = [abs(p - r["total"]) / max(abs(r["total"]), 1e-30)
            for p, r in zip(program["losses"], reference["losses"])]
    if len(gaps) != len(reference["losses"]) or any(not math.isfinite(g) for g in gaps):
        loss = (math.inf, -1)
    else:
        loss = max((g, i + 1) for i, g in enumerate(gaps))
    ref_grad = _norms(reference["first_grad"])
    prog_grad = _norms({k: v / (1.0 - b1) for k, v in program["first_moment"].items()})
    grad = worst_and_median(leaf_gaps(prog_grad, ref_grad))
    median_grad = statistics.median(ref_grad.values())
    moved = [k for k, n in ref_grad.items() if n >= ROUNDOFF_SHARE * median_grad]
    p0 = program["params0"]
    ref_change = _norms({k: reference["params"][k].cpu() - p0[k] for k in moved})
    prog_change = _norms({k: program["params"][k] - p0[k] for k in moved})
    update = worst_and_median(leaf_gaps(prog_change, ref_change))
    return {"loss_gap": {"value": loss[0], "step": loss[1]},
            "grad_gap": {"value": grad[0], "leaf": grad[1]},
            "update_gap": {"value": update[0], "leaf": update[1],
                           "leaves_left_out": len(ref_grad) - len(moved)},
            "grad_gap_median": {"value": grad[2]},
            "update_gap_median": {"value": update[2]}}


def judge(found: Dict[str, dict], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """Whether every number that has a limit is within it, and each as a
    check line."""
    lines = [{"name": k, "value": found[k]["value"], "limit": v} for k, v in limits.items()]
    return all(x["value"] <= x["limit"] for x in lines), lines
