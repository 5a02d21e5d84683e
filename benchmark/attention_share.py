"""The share of its bound that one family of the port's attention kernels
reaches in the profiled stretch: the recorded calls' bounds
(``bounds.attention_bound``, forward and, for a call under grad, backward)
over the device time of the family's kernels.

A kernel's family comes from its name: the port's kernels live in the
``kokoro_attn`` namespace, and their templates carry the flash flag as
their second argument (``fwd_kernel<64, true, ...>`` is K4's); the
scores-in-memory kernels and the one-argument wide kernels are K4's.
"""

from __future__ import annotations

import re
from typing import Optional

from benchmark.bounds import attention_bound

_FLAG = re.compile(r"<\d+, (true|false)")


def family(name: str) -> Optional[str]:
    if "kokoro_attn" not in name:
        return None
    if "::scores" in name:
        return "flash"
    flag = _FLAG.search(name)
    if flag is None:
        return "flash"
    return "flash" if flag.group(1) == "true" else "packed"


def bound_seconds(calls, kind: str) -> float:
    total = 0.0
    for x in calls:
        if x["kind"] != kind:
            continue
        shape = (x["B"], x["T"], x["H"], x["Dh"], x["dtype"], x["causal"], x["kv_lengths"])
        total += attention_bound(*shape)["bound_s"]
        if x["grad"]:
            total += attention_bound(*shape, backward=True)["bound_s"]
    return total


def share(r, kind: str) -> Optional[float]:
    """Percent of the bound, or None where the stretch ran none of them."""
    if r.trace is None:
        return None
    spent = sum(s for n, s in r.trace["kernels"] if family(n) == kind)
    bound = bound_seconds(r.calls, kind)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
