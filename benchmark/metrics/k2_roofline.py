"""K2's share of its roofline: the least time of one frame's K2 work (counted
by the benchmark's walk, roofline.py) over K2's mean device time a launch in
the profiled burst, in %."""

KERNEL = "render_primary_kernel"


def read(t):
    us, n = t.kernel_us(KERNEL)
    least = t.work.get("k2")
    if not n or least is None:
        return None
    return 100.0 * least / (us / n / 1e3)
