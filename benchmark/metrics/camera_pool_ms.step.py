"""Host milliseconds a path-tracer step in its camera pool: the program's
`pathtracer.camera_pool` spans (the QMC jitter and the camera rays),
summed over the profiled burst and divided by its steps."""

NOTE = "pathtracer.camera_pool"


def read(t):
    durs = [du for name, _, du in t.burst["notes"] if name == NOTE]
    if t.unit != "step" or not durs:
        return None
    return sum(durs) / t.burst["iterations"] / 1e3
