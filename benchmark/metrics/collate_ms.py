"""collate_ms: host milliseconds a step in the port's ``collate`` and the
copy of its batch to the device, on the host clock around the harness's
call, over the window's steps outside the profiled stretch; layer: data
batching.  Nothing to read where the traffic is resident on the device."""


def read(r):
    times = r.window["collate_s"]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
