"""Share of the traced slice in which no operation ran on the device, in
percent: from the slice profiled with device activity alone, so that the
profiler's host-side recording does not stretch the slice."""


def read(ctx):
    p = ctx["profile"]
    if p is None or not p["device_ops"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
