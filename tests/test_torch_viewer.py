"""The port's headless Viewer (engine/viewer.py), its `fly` CLI and the
Viewer's present paths, on the CPU: the JAX package's tests/test_viewer.py
for everything that needs neither the HTTP server nor the window, and the
framebuffer against the JAX Viewer's.

Frames are held to the JAX Viewer's at 1e-5 outside counted rounding-
sensitive pixels (tests/torch_bridge.py; at most 1% of a frame). On the CPU
both Viewers render in tiles through their plain paths, which walk the same
tree in the same order, so exact-t ties go the same way. Above 16 lights the
card's kernels sample one light per pixel; on the CPU the plain path loops
over every light, so the idle-frame refinement is exercised with the plain
single-sample render standing in for the kernel and held statistically."""

import os

import numpy as np
import pytest
import torch

from torch_bridge import (f16_attenuation_flips, port_scene_from_jax,
                          rounding_sensitive_pixels)

from gpu_raytracer_tpu import RaytracerConfig as JaxConfig
from gpu_raytracer_tpu.engine.viewer import Viewer as JaxViewer
from gpu_raytracer_tpu.models.scene import build_default_scene as jax_default
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.engine.renderer import light_uniforms
from gpu_raytracer_tpu_torch.ops.render import render_chunk
from gpu_raytracer_tpu_torch.engine.viewer import Viewer
from gpu_raytracer_tpu_torch.models.scene import build_default_scene
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.cuda.render import MAX_LIGHTS
from gpu_raytracer_tpu_torch.ops.trace import trace
from gpu_raytracer_tpu_torch.utils.image import to_u8
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

TOL = 1e-5
MAX_COUNTED_SHARE = 0.01


@pytest.fixture(scope="module")
def demo():
    return build_default_scene()


def _viewer(scene, w=64, h=48, **kw):
    # 32-pixel tiles, so the cursor advances frame by frame
    return Viewer(scene, w, h, config=RaytracerConfig(tile_size=32), verbose=False,
                  device="cpu", **kw)


def test_progressive_frames_fill_framebuffer(demo):
    v = _viewer(demo)
    assert v.progressive.total_tiles == 4   # 2 x 2 tiles of 32 over 64 x 48
    assert v.run_compute() >= 1
    v.render_to_completion()
    assert v.progressive.complete
    assert v.run_compute() == 0             # an idle frame renders nothing
    assert np.isfinite(v.framebuffer).all() and v.framebuffer.max() > 0.0


def test_key_movement_triggers_recompute(demo):
    v = _viewer(demo)
    v.render_to_completion()
    fb1 = v.framebuffer.copy()
    v.handle_key("a")
    assert not v.progressive.complete
    v.render_to_completion()
    assert not np.array_equal(fb1, v.framebuffer)


def test_mouse_drag_rotates(demo):
    v = _viewer(demo)
    d0 = v.controller.direction.copy()
    v.handle_mouse_drag(50.0, 10.0)
    assert not np.allclose(d0, v.controller.direction)
    assert abs(np.linalg.norm(v.controller.direction) - 1.0) < 1e-5
    assert np.allclose(v.scene.camera.direction.numpy(), v.controller.direction)


def test_keys_toggle_and_quit(demo):
    v = _viewer(demo)
    seq = []
    for _ in range(4):
        v.handle_key("i")
        seq.append(v.fly_interleave)
    assert seq == [8, 1, 2, 4]
    v.handle_key("n")
    v.handle_key("t")
    assert not v.denoise and not v.temporal
    v.handle_key("q")                       # not a key of the viewer: nothing
    assert not v.should_quit
    v.handle_key("escape")
    assert v.should_quit


def test_failed_gltf_load_keeps_scene(demo, tmp_path, monkeypatch):
    v = _viewer(demo)
    before = v.scene
    v.load_gltf("/nonexistent/model.gltf")
    assert v.scene is before
    monkeypatch.chdir(tmp_path)             # 'l' loads model.gltf, absent here
    v.handle_key("l")
    assert v.scene is before


def test_fly_through_script(demo):
    v = _viewer(demo, 32, 32)
    frames = v.fly_through([("key", "w"), ("mouse", 20.0, 0.0), ("key", "s")],
                           frames_per_step=1)
    assert len(frames) == 3
    assert all(np.isfinite(f).all() for f in frames)
    assert not np.array_equal(frames[0], frames[1])


def test_edge_tiles_clamp(demo):
    v = _viewer(demo, 50, 40)               # ragged edge tiles
    v.render_to_completion()
    assert v.framebuffer.shape == (40, 50, 3) and np.isfinite(v.framebuffer).all()
    whole = Viewer(demo, 50, 40, verbose=False, device="cpu")   # one 128-pixel tile
    whole.render_to_completion()            # each pixel its own value either way
    assert np.array_equal(whole.framebuffer, v.framebuffer)


def _counted(ps, W, H, shadows):
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(ps.camera, W, H, px.reshape(-1), py.reshape(-1))
    flips = f16_attenuation_flips(ps, trace(ps, o, d)).reshape(H, W)
    return flips | rounding_sensitive_pixels(ps, W, H, shadows=shadows)


def _assert_close(got, want, ps, W, H, shadows):
    counted = _counted(ps, W, H, shadows)
    assert counted.sum() <= MAX_COUNTED_SHARE * counted.size, counted.sum()
    diff = np.abs(got - want).max(axis=-1)
    assert diff[~counted].max() <= TOL, f"{diff[~counted].max():.3g} off {counted.sum()} counted"


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, fn in (("default", jax_default), ("courtyard", lambda: jax_courtyard(2000, seed=1))):
        js = fn()
        out[name] = (js, port_scene_from_jax(js))
    return out


@pytest.mark.parametrize("name", ["default", "courtyard"])
def test_framebuffer_matches_the_jax_viewer(pairs, name):
    """render_to_completion after a camera move, tile by tile, against the
    JAX Viewer on the same scene, keys and tile size."""
    js, ps = pairs[name]
    W, H = 64, 48
    jv = JaxViewer(js, W, H, config=JaxConfig(tile_size=32), shadows=True, verbose=False)
    v = Viewer(ps, W, H, config=RaytracerConfig(tile_size=32), shadows=True, verbose=False,
               device="cpu")
    for viewer in (jv, v):
        viewer.handle_key("w")
        viewer.handle_mouse_drag(12.0, -3.0)
    want = jv.render_to_completion()
    got = v.render_to_completion()
    assert got.shape == (H, W, 3) and got.max() > 0.05
    _assert_close(got, want, v.scene, W, H, shadows=True)


def test_update_geometry_matches_the_jax_viewer(pairs):
    """A topology refit through the Viewer, on both packages: the frame
    after it is the moved geometry's, in both."""
    js, ps = pairs["courtyard"]
    W, H = 64, 48
    moved = (np.asarray(js.mesh.vertices) * np.float32(1.05)
             + np.float32([0.0, 0.3, 0.0])).astype(np.float32)
    jv = JaxViewer(js, W, H, config=JaxConfig(tile_size=32), shadows=True, verbose=False)
    v = Viewer(ps, W, H, config=RaytracerConfig(tile_size=32), shadows=True, verbose=False,
               device="cpu")
    before = v.render_to_completion().copy()
    for viewer in (jv, v):
        viewer.update_geometry(moved)
        assert not viewer.progressive.complete
    want = jv.render_to_completion()
    got = v.render_to_completion()
    assert not np.array_equal(got, before)
    _assert_close(got, want, v.scene, W, H, shadows=True)
    assert torch.equal(v.scene.mesh.vertices, torch.from_numpy(moved))
    assert v.renderer.tables.trace.scene.tri_v0 is v.scene.tri_v0


def test_viewer_pathtrace_toggle(demo):
    v = _viewer(demo, 32, 32)
    v.handle_key("p")
    assert v.pathtrace
    v.run_compute()
    v.run_compute()
    assert v._pt.samples == 2
    fb = v.framebuffer
    assert np.isfinite(fb).all() and fb.shape == (32, 32, 3)
    v.handle_key("w")              # the warp waits for the next frame
    v.run_compute()
    assert v._pt.samples == 0      # history folded into per-pixel weights
    assert v._pt._count_base is not None
    v.handle_key("p")
    assert not v.pathtrace
    v.render_to_completion()       # the Whitted path still works
    assert np.isfinite(v.framebuffer).all()


def test_viewer_denoised_pathtrace_preview(demo):
    v = _viewer(demo, 32, 32)
    v.handle_key("p")
    v.run_compute()
    fb_dn = v.framebuffer.copy()
    assert np.isfinite(fb_dn).all()
    assert not np.allclose(fb_dn, v._pt.image())   # filtered, not the raw mean
    v.handle_key("n")
    assert not v.denoise
    v.run_compute()
    assert np.allclose(v.framebuffer, v._pt.image())
    v.handle_key("n")
    v.denoise_until = 2                            # samples == 2: the raw mean
    v.run_compute()
    assert np.allclose(v.framebuffer, v._pt.image())


def test_viewer_temporal_toggle(demo):
    v = _viewer(demo, 32, 32)
    assert v.temporal
    v.handle_key("p")
    v.run_compute()
    v.run_compute()
    v.handle_key("w")
    v.run_compute()
    assert v._pt.samples == 0 and v._pt._count_base is not None
    assert np.isfinite(v.framebuffer).all()
    v.handle_key("t")
    v.handle_key("w")
    assert v._pt._count_base is None               # a plain restart


def test_load_gltf_resets_pathtracer(demo, tmp_path):
    from gltf_fixtures import cornell_box_gltf, write_gltf

    v = _viewer(demo, 32, 32)
    v.handle_key("p")
    v.run_compute()
    stale = v._pt
    v.load_gltf(write_gltf(tmp_path / "box.gltf", cornell_box_gltf()))
    assert v._pt is None
    v.run_compute()                                # still path tracing: the new scene
    assert v.pathtrace and v._pt is not stale
    assert v._pt.scene.tri_v0 is v.scene.tri_v0
    assert v.scene.num_triangles != demo.num_triangles


def test_update_geometry_resets_pathtracer(demo):
    v = _viewer(demo, 32, 32)
    v.handle_key("p")
    v.run_compute()
    assert v._pt.samples == 1
    base = demo.mesh.vertices.numpy()
    v.update_geometry(base + np.float32([0.0, 0.25, 0.0]))
    assert v._pt.samples == 0                      # the accumulation restarted
    assert v._pt.scene.tri_v0 is v.scene.tri_v0    # the new geometry, not the old
    assert v._pt.tables.render.trace.scene is v._pt.scene
    v.run_compute()
    assert np.isfinite(v.framebuffer).all()


def test_renderer_and_path_tracer_both_see_the_refit(demo):
    """After update_geometry both the Whitted frame and the path tracer's
    G-buffer are the moved geometry's: each equals a fresh one on a scene
    built from the moved mesh's refit."""
    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.engine.renderer import Renderer
    from gpu_raytracer_tpu_torch.models.scene import refit_scene

    v = _viewer(demo, 32, 32)
    v.handle_key("p")
    v.run_compute()
    moved = demo.mesh.vertices.numpy() + np.float32([0.2, 0.1, 0.0])
    v.update_geometry(moved)
    fresh = refit_scene(demo, moved)
    pt_fresh = PathTracer(fresh, 32, 32, device="cpu")
    for a, b in zip(v._pt.gbuffer(), pt_fresh.gbuffer()):
        assert torch.equal(a, b)
    v.handle_key("p")
    got = v.render_to_completion()
    assert np.array_equal(got, Renderer(fresh, 32, 32, device="cpu").render())


def test_viewer_resize(demo):
    v = _viewer(demo, 64, 48)
    v.render_to_completion()
    assert v.framebuffer.shape == (48, 64, 3)
    v.resize(40, 24)
    assert not v.progressive.complete
    v.render_to_completion()
    fb = v.framebuffer
    assert fb.shape == (24, 40, 3) and np.isfinite(fb).all() and fb.max() > 0.0
    v.handle_key("p")
    v.run_compute()
    v.resize(32, 32)
    v.run_compute()
    assert v.framebuffer.shape == (32, 32, 3)


def test_many_light_viewer_refines_while_idle():
    """Whole-frame mode above MAX_LIGHTS lights (the card's mode), with the
    plain single-sample render of each frame's light choices standing in
    for the kernels: idle frames average fresh choices, and the mean of 8
    approaches the loop over every light."""
    scene = make_courtyard_scene(1500, seed=3, lights=64)
    assert scene.lights.count > MAX_LIGHTS
    W, H = 64, 32
    v = Viewer(scene, W, H, verbose=False, device="cpu")
    v.device = torch.device("cuda")     # pick the card's whole-frame mode
    v._sync_mode()
    r = v.renderer
    r.render_device = lambda: render_chunk(
        r.scene, r.px, r.py, W, H, light_u=light_uniforms(W * H, r.light_frame, 0, "cpu"))
    assert v._whole_frame and v.run_compute() == 1
    fb1 = v.framebuffer.copy()
    exact = r.to_image(render_chunk(r.scene, r.px, r.py, W, H).numpy())
    for _ in range(7):
        assert v.run_compute() == 0     # idle frames refine, they do not redraw
    assert v._nee_samples == 8
    err1 = np.abs(fb1 - exact).mean()
    err8 = np.abs(v.framebuffer - exact).mean()
    assert err8 < err1 * 0.6            # ~1/sqrt(8) expected
    v.handle_key("w")                   # a move restarts the mean
    v.run_compute()
    assert v._nee_samples == 1


def test_framebuffer_u8_matches_quantised_f32(demo):
    v = _viewer(demo, 32, 32)
    v.render_to_completion()
    got = v.framebuffer_u8
    assert got.dtype == np.uint8
    assert np.array_equal(got, to_u8(v.framebuffer))
    v.handle_key("p")
    v.run_compute()
    got = v.framebuffer_u8                          # quantised on the frame's device
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - to_u8(v.framebuffer).astype(int)).max() <= 1


def test_pathtrace_fly_through_keeps_history(demo):
    v = _viewer(demo, 32, 32)
    v.handle_key("p")
    for _ in range(3):
        v.frame()
    assert v._pt.samples == 3
    frames = v.fly_through([("key", "w"), ("mouse", 15.0, 0.0)], frames_per_step=1)
    assert len(frames) == 2 and all(np.isfinite(f).all() for f in frames)
    assert v._pt._count_base is not None
    assert float(v._pt._count_base.max()) > 1.0
    assert v._pt.samples == 0


def test_present_frame_pipelining_semantics(demo):
    """present_frame: a tensor for a path-traced frame (quantise enqueued,
    nothing read back), a host array otherwise; an old handle still holds
    its own frame after later frames."""
    v = _viewer(demo, 32, 32)
    v.render_to_completion()
    h0 = v.present_frame()
    assert isinstance(h0, np.ndarray) and h0.dtype == np.uint8
    v.handle_key("p")
    v.run_compute()
    h1 = v.present_frame()
    assert isinstance(h1, torch.Tensor) and h1.dtype == torch.uint8
    want1 = v.framebuffer_u8
    v.run_compute()
    h2 = v.present_frame()
    assert np.array_equal(v.materialize_frame(h1), want1)
    assert not np.array_equal(v.materialize_frame(h2), want1)
    assert np.array_equal(v.materialize_frame(h2), v.framebuffer_u8)


def test_packed_present_matches_u8_present():
    v = Viewer(build_default_scene(), 64, 64, verbose=False, device="cpu")
    v.handle_key("p")
    v.run_compute()
    u8 = v.materialize_frame(v.present_frame())
    packed = v.present_frame_packed()
    assert isinstance(packed, torch.Tensor) and packed.shape == (96, 64)
    rgb = v.materialize_frame(packed)
    assert rgb.shape == u8.shape and rgb.dtype == np.uint8
    err = np.abs(rgb.astype(int) - u8.astype(int))
    assert np.median(err) <= 1 and err.mean() < 3.0


def test_host_frame_bytes_and_lifetime():
    """The read-back handle behind a CUDA present (engine/viewer.py::
    HostFrame; on the CPU its copy is plain): a handle materialises to the
    bytes a blocking read gives, RGB or decoded YUV, and keeps its own frame
    however many later handles of its shape follow, the frame it was made
    from written over or not."""
    from gpu_raytracer_tpu_torch.engine.viewer import HostFrame
    from gpu_raytracer_tpu_torch.utils.yuv import decode_yuv420

    gen = torch.Generator().manual_seed(5)
    frames = [torch.randint(0, 256, (4, 6, 3), dtype=torch.uint8, generator=gen)
              for _ in range(4)]
    want = [f.clone() for f in frames]
    h0 = HostFrame(frames[0])
    assert h0.shape == (4, 6, 3) and h0.event is None
    frames[0].zero_()                                     # the source written over
    later = [HostFrame(f) for f in frames[1:]]
    assert np.array_equal(Viewer.materialize_frame(h0), want[0].numpy())
    for h, w in zip(later, want[1:]):
        assert np.array_equal(Viewer.materialize_frame(h), w.numpy())
    yuv = torch.randint(0, 256, (6, 6), dtype=torch.uint8, generator=gen)
    hy = HostFrame(yuv)
    assert hy.shape == (6, 6)
    assert np.array_equal(Viewer.materialize_frame(hy), decode_yuv420(yuv))
    assert np.array_equal(Viewer.materialize_frame(h0), want[0].numpy())


@pytest.mark.parametrize("pathtrace", [False, True])
def test_cli_fly(tmp_path, pathtrace):
    from gpu_raytracer_tpu_torch.__main__ import main

    size = 32 if pathtrace else 8
    out = str(tmp_path / "frames")
    main(["fly", "--demo", "--width", str(size), "--height", str(size), "--device", "cpu",
          "--shadows", "--script", "w mouse:10,0 d", "-o", out]
         + (["--pathtrace", "--frames-per-step", "2"] if pathtrace else []))
    files = sorted(os.listdir(out))
    assert files == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    with open(os.path.join(out, files[0]), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
