"""K6's share of its roofline: the least time of one step's bounce work over
every depth (counted by the benchmark's reference path tracer, roofline.py)
over the bounce kernel's device time a step in the profiled burst, in %."""

KERNEL = "bounce_kernel"


def read(t):
    us, n = t.kernel_us(KERNEL)
    least = t.work.get("k6")
    if not n or least is None or t.unit != "step":
        return None
    return 100.0 * least / (us / t.burst["iterations"] / 1e3)
