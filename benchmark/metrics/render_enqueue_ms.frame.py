"""Host milliseconds a frame in the frame's kernel wrappers: the program's
`renderer.render` spans (Renderer.render_rays: K2, or the pre-pass, K3 and
K4), summed over the profiled burst and divided by its frames."""

NOTE = "renderer.render"


def read(t):
    durs = [du for name, _, du in t.burst["notes"] if name == NOTE]
    if t.unit != "frame" or not durs:
        return None
    return sum(durs) / t.burst["iterations"] / 1e3
