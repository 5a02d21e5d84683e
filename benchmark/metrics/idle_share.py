"""idle_share: the share of the profiled stretch in which no operation ran
on the device, in percent (the union of the device's activities against
the stretch's length); layer: device."""


def read(r):
    if r.trace is None or r.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
