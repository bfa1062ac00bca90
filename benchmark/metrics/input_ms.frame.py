"""Host milliseconds a frame in the Viewer's camera input: the program's
`viewer.input` spans (the camera controller and Renderer.set_camera's
camera row), summed over the profiled burst and divided by its frames."""

NOTE = "viewer.input"


def read(t):
    durs = [du for name, _, du in t.burst["notes"] if name == NOTE]
    if t.unit != "frame" or not durs:
        return None
    return sum(durs) / t.burst["iterations"] / 1e3
