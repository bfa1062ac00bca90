"""Share of the lanes handed to the bounce kernel that were live, in %: the
program's counters `pool.live` over `pool.lanes`, summed over every depth
of the profiled burst's steps (gpu_raytracer_tpu_torch.engine.perf's
recorder, which counts only while a profiler runs)."""


def read(t):
    if t.unit != "step":
        return None
    from gpu_raytracer_tpu_torch.engine import perf

    snapshot = getattr(perf, "snapshot", None)     # a program without the recorder
    if snapshot is None:
        return None
    counters = snapshot()["counters"]
    lanes, live = counters.get("pool.lanes"), counters.get("pool.live")
    if not lanes or live is None:
        return None
    return 100.0 * live / lanes
