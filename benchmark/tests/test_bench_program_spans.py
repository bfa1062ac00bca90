"""The per-layer metrics read from the program's own spans and counters,
on synthetic traces: each reads its span's notes as ms a frame or step,
and none reads a cell of the other unit or a trace without its span."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run

SPAN_METRICS = {   # metric -> (the program span it reads, the unit of its cells)
    "input_ms.frame": ("viewer.input", "frame"),
    "render_enqueue_ms.frame": ("renderer.render", "frame"),
    "camera_pool_ms.step": ("pathtracer.camera_pool", "step"),
    "order_ms.step": ("pool.order", "step"),
    "bounce_enqueue_ms.step": ("pool.bounce", "step"),
}


def trace(unit, notes, iterations=4):
    burst = dict(device=[], notes=notes, start_us=0.0, end_us=1e6, iterations=iterations)
    return run.Trace(unit, {}, burst, {}, {}, False)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_is_ms_an_iteration(metric):
    note, unit = SPAN_METRICS[metric]
    other = "step" if unit == "frame" else "frame"
    read = run.load_module("metrics", metric).read
    # four iterations and four of the span, 100 + 60 + 200 + 40 us,
    # beside the benchmark loop's own label and a span of another name
    notes = [("input_and_run_compute" if unit == "frame" else "step", 0.0, 900.0),
             (note, 10.0, 100.0), (note, 150.0, 60.0), (note, 300.0, 200.0),
             (note, 600.0, 40.0), ("other.span", 10.0, 500.0)]
    assert read(trace(unit, notes)) == pytest.approx(400.0 / 4 / 1e3)
    assert read(trace(other, notes)) is None
    assert read(trace(unit, [n for n in notes if n[0] != note])) is None


def test_bounce_live_share_reads_the_program_counters():
    from gpu_raytracer_tpu_torch.engine import perf

    read = run.load_module("metrics", "bounce_live_pct.step").read
    perf.reset()
    try:
        assert read(trace("step", [])) is None            # nothing counted
        with profile(activities=[ProfilerActivity.CPU]):
            for live in (1000, 600, 200):
                perf.count("pool.lanes", 1000)
                perf.count("pool.live", torch.tensor(live))
        assert read(trace("step", [])) == pytest.approx(100.0 * 1800 / 3000)
        assert read(trace("frame", [])) is None
    finally:
        perf.reset()
