"""step_mfu: the model FLOPs of the window's steps outside the profiled
stretch (``bounds.step_flops``: the forward's products from the batch
shapes, times three) over their seconds on the host clock, as a percent of
the card's dense bf16 peak (989 TFLOP/s); layer: device."""

from benchmark.bounds import PEAK_BF16


def read(r):
    w = r.window
    if not w["free_steps"] or w["free_seconds"] <= 0:
        return None
    return 100.0 * w["free_flops"] / w["free_seconds"] / PEAK_BF16
