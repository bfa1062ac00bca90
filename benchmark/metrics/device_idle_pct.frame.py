"""Share of the profiled burst of frames with no kernel and no copy on the
card, in %."""


def read(t):
    if t.unit != "frame":
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us())
