"""Host milliseconds a path-tracer step in the bounce kernel's wrapper: the
program's `pool.bounce` spans (fused_bounce_ at every depth), summed over
the profiled burst and divided by its steps."""

NOTE = "pool.bounce"


def read(t):
    durs = [du for name, _, du in t.burst["notes"] if name == NOTE]
    if t.unit != "step" or not durs:
        return None
    return sum(durs) / t.burst["iterations"] / 1e3
