"""The textured frame's kernels' share of their roofline: the least time of
one frame's pre-pass, K3 and K4 work (counted by the benchmark's walk,
roofline.py) over the three kernels' device time a frame in the profiled
burst, in %."""

KERNELS = ("camera_relative_kernel", "render_deferred_kernel", "texshade_kernel")


def read(t):
    us, n = t.kernel_us(*KERNELS)
    least = t.work.get("k3k4")
    if not n or least is None or t.unit != "frame":
        return None
    return 100.0 * least / (us / t.burst["iterations"] / 1e3)
