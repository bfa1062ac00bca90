"""Host milliseconds a PathTracer.step() takes to return, nothing waited
for: the mean over the window's steps."""


def read(t):
    v = t.spans.get("host_enqueue") if t.unit == "step" else None
    return sum(v) / len(v) * 1e3 if v else None
