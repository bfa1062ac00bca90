"""The fly frame's share of its roofline: the least time of one frame's warp,
coset step and filter (counted by the benchmark's reference, roofline.py
fly_frame) over the card's busy time a frame in the profiled burst (any
kernel, copy or memset running), in %."""


def read(t):
    least = t.work.get("fly")
    if least is None or t.unit != "frame" or not t.burst["device"]:
        return None
    return 100.0 * least / (t.busy_us() / t.burst["iterations"] / 1e3)
