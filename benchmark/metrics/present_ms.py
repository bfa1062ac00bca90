"""Host milliseconds a frame in the present: Viewer.present_frame_packed()
and materialize_frame() of the previous frame's handle, the mean over the
window's frames."""


def read(t):
    v = t.spans.get("present") if t.present else None
    return sum(v) / len(v) * 1e3 if v else None
