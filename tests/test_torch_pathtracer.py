"""The port's progressive path tracer (engine/pathtracer.py) against the JAX
package's CPU `PathTracer`: the same scene (carried across by the bridge),
the default arguments (spectral, shadows, QMC-jittered anti-aliasing, depth
4 with Russian roulette from depth 2), four steps.

Tolerance: the 4-spp image within 1e-5 of JAX's on at least 99% of the
pixels, and the per-depth live-lane counts of the last step equal up to 1%
of the pool. The rest are counted: JAX's CPU reference runs XLA's bounce,
whose fused multiply-adds move some floats by an ulp, and a discrete
decision (Fresnel, roulette, an absorbed metal lobe) that flips on such a
lane sends that pixel down another path. With QMC sampling a lane's
uniforms depend only on its pixel and sample, so the image does not depend
on where the sorts move a lane.

Checkpoints are `.npz` files with the same keys in both packages."""

import numpy as np
import pytest
import torch

from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu import build_default_scene as jax_default_scene
from gpu_raytracer_tpu.engine.pathtracer import PathTracer as JaxPathTracer
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer, render_pathtraced
from gpu_raytracer_tpu_torch.engine.renderer import Renderer
from gpu_raytracer_tpu_torch.models.camera import CameraController
from gpu_raytracer_tpu_torch.models.scene import build_default_scene
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

SPP = 4
TOL = 1e-5
MIN_SHARE = 0.99
SCENES = {"default": (jax_default_scene, 32),
          "courtyard3000": (lambda: jax_courtyard(3000, seed=0), 64),
          "textured_courtyard3000": (lambda: jax_courtyard(3000, seed=0, textured=True), 64)}


@pytest.fixture(scope="module")
def traced():
    """Per scene: (JAX tracer, port tracer), each after SPP steps."""
    out = {}
    for name, (make, size) in SCENES.items():
        js = make()
        jp = JaxPathTracer(js, size, size)
        pp = PathTracer(port_scene_from_jax(js), size, size, device="cpu")
        for _ in range(SPP):
            jp.step()
            pp.step()
        out[name] = (jp, pp)
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_image_matches_jax_pathtracer(traced, name):
    jp, pp = traced[name]
    got, want = pp.image(), jp.image()
    assert got.shape == want.shape == (pp.height, pp.width, 3)
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=2)
    share = (diff <= TOL).mean()
    assert share >= MIN_SHARE, f"{share:.4f} of the pixels within {TOL} (max {diff.max():.3g})"
    assert pp.samples == jp.samples == SPP
    np.testing.assert_array_equal(pp.image_device().numpy(), got)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_per_depth_counts_match_jax(traced, name):
    jp, pp = traced[name]
    got, want = pp.counters(), jp.counters()
    assert got.rays_per_bounce[0] == want.rays_per_bounce[0] == pp.width * pp.height
    for g, w in zip(got.rays_per_bounce, want.rays_per_bounce):
        assert abs(g - w) <= (1.0 - MIN_SHARE) * pp.width * pp.height
    assert got.active_bounce_depths == want.active_bounce_depths


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_load_in_the_other_package(traced, tmp_path, direction):
    jp, pp = traced["default"]
    path = str(tmp_path / "ckpt.npz")
    src, make_dst = ((jp, lambda: PathTracer(build_default_scene(), 32, 32, device="cpu"))
                     if direction == "jax_to_port"
                     else (pp, lambda: JaxPathTracer(jax_default_scene(), 32, 32)))
    src.save_checkpoint(path)
    dst = make_dst()
    dst.load_checkpoint(path)
    assert dst.samples == SPP
    np.testing.assert_array_equal(dst.image(), src.image())


def test_samples_per_step_tiles_the_pool_chunk_major():
    """One step of two samples per pixel traces the same two samples as two
    steps of one (QMC: a lane's numbers follow its pixel and sample)."""
    scene = build_default_scene()
    one = PathTracer(scene, 16, 16, device="cpu")
    two = PathTracer(scene, 16, 16, samples_per_step=2, device="cpu")
    one.step()
    one.step()
    two.step()
    assert one.samples == two.samples == 2
    np.testing.assert_allclose(two.image(), one.image(), rtol=0, atol=1e-6)


def test_rng_sampler_and_rgb_mode_run():
    img = render_pathtraced(build_default_scene(), 16, 12, spp=2, sampler="rng",
                            spectral=False, device="cpu")
    assert img.shape == (12, 16, 3) and np.isfinite(img).all() and img.max() > 0


def test_set_camera_restarts_and_unported_modes_raise():
    """set_camera restarts the accumulation; the modes that raised
    NotImplementedError until the interactive stack was ported (temporal
    warp, interleaved step, G-buffer, denoised outputs, fly frame) run on
    the CPU now (their parity with the JAX package: test_torch_temporal,
    test_torch_interleave, test_torch_denoise, test_torch_fly)."""
    pt = PathTracer(build_default_scene(), 16, 16, device="cpu")
    pt.step()
    cam = pt.scene.camera
    pt.set_camera(cam)
    assert pt.samples == 0 and not pt.accum.any()
    pt.step()
    pt.set_camera(cam, temporal=True)
    assert pt.samples == 0 and pt._count_base is not None and pt._gbuf_tile is not None
    pt.step_interleaved()
    assert pt._count_base.sum().item() > 0
    normal, depth, albedo = pt.gbuffer()
    assert normal.shape == albedo.shape == (16, 16, 3) and depth.shape == (16, 16)
    assert pt.denoised_frame().shape == (16, 16, 3)
    assert pt.denoised_image().shape == (16, 16, 3)
    frame = pt.fly_frame(cam, u8=True)
    assert frame.shape == (16, 16, 3) and frame.dtype == torch.uint8


@pytest.mark.parametrize("entry", [Renderer, PathTracer])
def test_entry_points_default_to_cuda(entry):
    """Without a device argument an entry point runs on CUDA, and raises
    where there is none; the plain path is only taken when asked for."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(build_default_scene(), 16, 16)


def test_64_spp_image_matches_jax_pathtracer():
    """64 steps of one sample each on the default scene (spheres, glass,
    metal): the accumulated image against the JAX package's, at the 4-spp
    test's tolerance."""
    js = jax_default_scene()
    jp = JaxPathTracer(js, 32, 32)
    pp = PathTracer(port_scene_from_jax(js), 32, 32, device="cpu")
    for _ in range(64):
        jp.step()
        pp.step()
    got, want = pp.image(), jp.image()
    assert pp.samples == jp.samples == 64 and np.isfinite(got).all()
    share = (np.abs(got - want).max(axis=2) <= TOL).mean()
    assert share >= MIN_SHARE, f"{share:.4f} of the pixels within {TOL}"


@pytest.mark.parametrize("size", [(1920, 1080), (96, 64), (100, 70), (64, 64), (128, 192)])
def test_warp_compact_pixel_order_visits_every_pixel_once(size):
    """`tiled_pixel_order(warp=(8, 4))`: the same tiles in the same order,
    every pixel once, 32 consecutive pixels an 8 x 4 block wherever the tile
    is whole; the default stays the JAX package's row-major tiles."""
    from gpu_raytracer_tpu.ops.packet_trace import tiled_pixel_order as jax_order
    from gpu_raytracer_tpu_torch.engine.renderer import TILE, WARP_BLOCK, tiled_pixel_order

    w, h = size
    px, py = tiled_pixel_order(w, h)
    if w % TILE == 0 and h % TILE == 0:   # (JAX pads a ragged frame with clamped lanes)
        jx, jy = jax_order(w, h, tile=TILE)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
    wx, wy = tiled_pixel_order(w, h, warp=WARP_BLOCK)
    assert wx.dtype == wy.dtype == np.int32 and WARP_BLOCK == (8, 4)
    flat = wy.astype(np.int64) * w + wx
    assert np.array_equal(np.sort(flat), np.arange(w * h))
    # tile by tile the same pixels as the default order
    tile_of = lambda x, y: (y // TILE) * ((w + TILE - 1) // TILE) + x // TILE
    np.testing.assert_array_equal(tile_of(wx, wy), tile_of(px, py))
    if w % 8 == 0 and h % 4 == 0:
        bx, by = wx.reshape(-1, 32), wy.reshape(-1, 32)
        assert ((bx.max(1) - bx.min(1)) == 7).all() and ((by.max(1) - by.min(1)) == 3).all()
        assert (bx.min(1) % 8 == 0).all() and (by.min(1) % 4 == 0).all()
    with pytest.raises(ValueError, match="blocks"):
        tiled_pixel_order(w, h, warp=(6, 4))


@pytest.mark.parametrize("textured", [False, True])
def test_renderer_frames_do_not_depend_on_the_pixel_order(textured):
    """A frame rendered in the warp-compact order is the default order's
    frame, pixel for pixel."""
    from gpu_raytracer_tpu_torch.engine.renderer import WARP_BLOCK, tiled_pixel_order
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    scene = make_courtyard_scene(1500, seed=4, textured=textured)
    r = Renderer(scene, 72, 40, shadows=True, device="cpu")
    want = r.render()
    np.testing.assert_array_equal(r._px_host, tiled_pixel_order(72, 40)[0])
    wx, wy = tiled_pixel_order(72, 40, warp=WARP_BLOCK)
    r._px_host, r._py_host = wx, wy
    r.px, r.py = torch.from_numpy(wx), torch.from_numpy(wy)
    assert not np.array_equal(wx, tiled_pixel_order(72, 40)[0])
    np.testing.assert_array_equal(r.render(), want)


def _moved(camera):
    ctrl = CameraController(camera)
    ctrl.move(forward=1.5, strafe=0.5)
    ctrl.rotate(10.0, -5.0)
    return ctrl.camera()


def test_set_camera_keeps_the_tables_and_steps_as_a_fresh_tracer():
    """After a move the bounce tables are the same tensors (camera row
    rewritten in place), and the next step equals a fresh tracer's first."""
    scene = make_courtyard_scene(1500, seed=0, textured=True)
    pt = PathTracer(scene, 16, 16, device="cpu")
    pt.step()
    t = pt.tables
    kept = (t.render.camera, t.render.trace.nodes, t.render.materials, t.shade.maps,
            t.shade.levels, t.shade.atlas, t.shade.materials)
    cam = _moved(scene.camera)
    pt.set_camera(cam)
    assert pt.tables is t and pt.samples == 0
    assert all(a is b for a, b in zip(kept, (t.render.camera, t.render.trace.nodes,
                                             t.render.materials, t.shade.maps, t.shade.levels,
                                             t.shade.atlas, t.shade.materials)))
    pt.step()
    fresh = PathTracer(scene.with_camera(cam), 16, 16, device="cpu")
    fresh.step()
    assert torch.equal(t.render.camera, fresh.tables.render.camera)
    assert np.array_equal(pt.image(), fresh.image())
