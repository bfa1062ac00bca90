"""Kernels, copies and memsets on the card a frame, counted in the profiled
burst."""


def read(t):
    if t.unit != "frame" or not t.burst["device"]:
        return None
    return len(t.burst["device"]) / t.burst["iterations"]
