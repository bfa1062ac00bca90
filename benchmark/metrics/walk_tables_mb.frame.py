"""MB of node records and triangle rows that a frame kernel's launch walks
(K2, K2t or K3, the camera-relative tables included where the launch reads
them): the program's counter `render.table_bytes` (gpu_raytracer_tpu_torch.
engine.perf's recorder, which counts only while a profiler runs) over the
profiled burst, over the launches of those kernels in it. The H100's L2
holds 50 MB."""

KERNELS = ("render_primary_kernel", "render_deferred_kernel")


def read(t):
    if t.unit != "frame":
        return None
    from gpu_raytracer_tpu_torch.engine import perf

    snapshot = getattr(perf, "snapshot", None)     # a program without the recorder
    if snapshot is None:
        return None
    total = snapshot()["counters"].get("render.table_bytes")
    _, launches = t.kernel_us(*KERNELS)
    if not total or not launches:
        return None
    return total / launches / 1e6
