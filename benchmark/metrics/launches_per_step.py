"""launches_per_step: device kernels launched a training step in the
profiled stretch (``torch.profiler``; copies and fills not counted); layer:
training step."""


def read(r):
    if r.trace is None or not r.trace["kernels"]:
        return None
    return r.trace["launches"]
