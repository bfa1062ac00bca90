"""Host milliseconds a path-tracer step in the coherence orders of depths 1
and on: the program's `pool.order` spans (key, radix sort, gathers),
summed over the profiled burst and divided by its steps."""

NOTE = "pool.order"


def read(t):
    durs = [du for name, _, du in t.burst["notes"] if name == NOTE]
    if t.unit != "step" or not durs:
        return None
    return sum(durs) / t.burst["iterations"] / 1e3
