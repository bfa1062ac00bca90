"""Kernels and copies on the card a path-tracer step, counted in the profiled
burst."""


def read(t):
    if t.unit != "step" or not t.burst["device"]:
        return None
    return len(t.burst["device"]) / t.burst["iterations"]
