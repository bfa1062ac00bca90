"""Host milliseconds a frame from applying its input to the return of
Viewer.run_compute(), nothing waited for: the mean over the window's frames."""


def read(t):
    v = t.spans.get("host_enqueue") if t.unit == "frame" else None
    return sum(v) / len(v) * 1e3 if v else None
