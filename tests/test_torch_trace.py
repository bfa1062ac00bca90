"""The program's spans and counters (engine/perf.py: `span`, `count`,
`snapshot`) on the CPU: off without a profiler, and under a CPU-only
torch.profiler nested in the exported trace as the calls nest, with the
bounce's lane counters equal to the step's own counts, and the frame
kernels' table counters read from shapes alone."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_bridge  # noqa: F401  (thread cap)

from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.engine import perf
from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
from gpu_raytracer_tpu_torch.engine.viewer import Viewer
from gpu_raytracer_tpu_torch.models.scene import build_default_scene

W, H = 16, 12


@pytest.fixture(scope="module")
def scene():
    return build_default_scene()


@pytest.fixture(autouse=True)
def empty_recorder():
    perf.reset()
    yield
    perf.reset()


def traced(fn, tmp_path):
    """Run `fn` under a CPU-only profiler -> the trace's user annotations,
    (name, start us, end us), in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    notes = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return sorted(notes, key=lambda n: n[1])


def inside(notes, outer, name):
    """The spans called `name` that lie within span `outer`."""
    _, lo, hi = outer
    return [n for n in notes if n[0] == name and lo <= n[1] and n[2] <= hi]


def named(notes, name):
    return [n for n in notes if n[0] == name]


def test_no_profiler_no_span_and_no_count(scene):
    assert perf.span("pathtracer.step") is perf.span("viewer.input")
    with perf.span("pathtracer.step"):
        perf.count("pool.lanes", 7)
    pt = PathTracer(scene, W, H, device="cpu")
    pt.step()
    assert perf.snapshot() == {"spans": {}, "counters": {}}


def test_step_spans_nest_inside_the_step(scene, tmp_path):
    pt = PathTracer(scene, W, H, device="cpu")
    notes = traced(pt.step, tmp_path)
    (step,) = named(notes, "pathtracer.step")
    depths = pt.config.max_bounce_depth + 1
    assert len(inside(notes, step, "pathtracer.camera_pool")) == 1
    assert len(inside(notes, step, "pool.order")) == depths - 1
    assert len(inside(notes, step, "pool.bounce")) == depths
    assert len(inside(notes, step, "pathtracer.accumulate")) == 1
    # the same names reach the recorder, with their host time
    spans = perf.snapshot()["spans"]
    assert spans["pathtracer.step"]["calls"] == 1 and spans["pool.bounce"]["calls"] == depths
    assert spans["pathtracer.step"]["ns"] >= spans["pool.bounce"]["ns"] > 0


def test_viewer_spans_nest_inside_input_and_compute(scene, tmp_path):
    v = Viewer(scene, W, H, config=RaytracerConfig(tile_size=8), verbose=False, device="cpu")

    def frame():
        v.handle_mouse_drag(4.0, -2.0)
        v.run_compute()

    notes = traced(frame, tmp_path)
    (inp,) = named(notes, "viewer.input")
    (comp,) = named(notes, "viewer.run_compute")
    assert len(inside(notes, inp, "renderer.set_camera")) == 1
    renders = inside(notes, comp, "renderer.render")
    assert renders and len(renders) == len(named(notes, "renderer.render"))
    assert inp[2] <= comp[1]


@pytest.mark.parametrize("key, moves", [("w", True), ("d", True), ("space", True),
                                        ("n", False), ("t", False)])
def test_a_key_is_input_only_where_it_sets_the_camera(scene, tmp_path, key, moves):
    v = Viewer(scene, W, H, verbose=False, device="cpu")
    notes = traced(lambda: v.handle_key(key), tmp_path)
    assert len(named(notes, "viewer.input")) == int(moves)
    assert len(named(notes, "renderer.set_camera")) == int(moves)


def test_bounce_counters_match_the_step_counts(scene, tmp_path):
    pt = PathTracer(scene, W, H, device="cpu")
    traced(pt.step, tmp_path)
    got = perf.snapshot()["counters"]
    depths = pt.config.max_bounce_depth + 1
    assert got["pool.lanes"] == W * H * depths
    assert got["pool.live"] == sum(pt.counters().rays_per_bounce)
    assert 0 < got["pool.live"] < got["pool.lanes"]


def test_snapshot_sums_tensors_and_ints_and_reset_clears():
    with profile(activities=[ProfilerActivity.CPU]):
        perf.count("c", 3)
        perf.count("c", torch.tensor(4))
        perf.count("c", torch.tensor(5, dtype=torch.int64))
        with perf.span("s"):
            pass
    perf.count("c", 100)                     # the profiler has stopped: not counted
    snap = perf.snapshot()
    assert snap["counters"] == {"c": 12}
    assert snap["spans"]["s"]["calls"] == 1
    perf.reset()
    assert perf.snapshot() == {"spans": {}, "counters": {}}


def _meta_render_tables(q, slots, stack):
    """Render tables of q width-4 node records and `slots` triangle slots
    on the meta device: shapes without data, so any read of a value raises."""
    from gpu_raytracer_tpu_torch.ops.cuda.render import RenderTables
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import TraceTables

    meta = lambda *shape: torch.empty(shape, device="meta")
    trace = TraceTables(scene=None, nodes=meta(q, 32), tris=meta(slots, 12),
                        attrs=meta(slots, 8), depth=11, stack=stack)
    return RenderTables(trace, meta(16), meta(5, 16), meta(2, 16), meta(0, 8), 0.4, 45.0,
                        rel_nodes=meta(q, 32), rel_tris=meta(slots, 16))


@pytest.mark.parametrize("rel", [False, True], ids=["k2", "camera_relative"])
def test_walk_counters_only_under_a_profiler(rel):
    """`count_walk`, called at every K2, K2t and K3 launch: under a profiler
    the bytes of the node and triangle tables the launch walks (the
    camera-relative ones too where it reads them); nothing without one. The tables live on the meta device, where a value
    cannot be read: the counts come from shapes alone, so they cannot make
    the host wait for the device."""
    from gpu_raytracer_tpu_torch.ops.cuda.render import count_walk

    tables = _meta_render_tables(96_290, 1_000_000, 64)
    count_walk(tables, rel)
    assert perf.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            count_walk(tables, rel)
    words = 96_290 * 32 + 1_000_000 * 12 + (96_290 * 32 + 1_000_000 * 16 if rel else 0)
    assert perf.snapshot()["counters"] == {"render.table_bytes": 3 * 4 * words}
    count_walk(tables, rel)                  # the profiler has stopped: not counted
    assert perf.snapshot()["counters"] == {"render.table_bytes": 3 * 4 * words}


def test_whole_frame_timing_only_when_verbose(scene, capsys):
    """The whole-frame branch's timer feeds only the verbose summary."""
    for verbose in (False, True):
        v = Viewer(scene, W, H, verbose=verbose, device="cpu")
        v._whole_frame = True                # the CUDA branch, on the CPU renderer
        v.progressive.tiles_x = v.progressive.tiles_y = 1
        v.progressive.total_tiles = v.progressive.tiles_per_frame = 1
        v.progressive.current_tile = 0
        v.renderer.render_device = lambda: torch.zeros((W * H, 3))
        v.progressive.trigger_recompute()
        assert v.run_compute() == 1
        assert len(v.timing.tile_times_ms) == int(verbose)
        out = capsys.readouterr().out
        assert ("Progressive pass complete: 1 tiles" in out) == verbose
