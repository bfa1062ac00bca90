"""Rendered frames of the port (plain path, on the CPU) against the JAX
package: its chunked XLA pipeline (`Renderer.render` / `render_chunk`), its
fused TPU kernel run by the Pallas interpreter, and the NumPy oracle.

Tolerance: max |diff| <= 1e-5 per channel. XLA:CPU contracts products and
sums into fused multiply-adds, the port (like the TPU kernel and the CUDA
kernel built with -fmad=false) rounds every product. The only pixels allowed
past the tolerance are counted ones where that choice can matter
(tests/torch_bridge.py): the f16 attenuation round trip sits on a rounding
boundary, or f32 rounding alone moves the pixel by more than 1e-6 from a
float64 evaluation (sphere silhouettes). They may be at most 1% of a frame.

Above 16 lights the JAX kernels evaluate one sampled light per ray, weighted
by the light count; with the same `light_u` from NumPy the port's plain
single-sample version agrees with the interpreted kernel within 1e-5 relative
to max(1, value) (a weight of 64 scales the rounding of a different
multiplication order), and the mean of 8 draws is within 8% of the exact loop
in sum, the bar of tests/test_pallas_render.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import f16_attenuation_flips, port_scene_from_jax, rounding_sensitive_pixels

from gpu_raytracer_tpu.engine.renderer import Renderer as JaxRenderer
from gpu_raytracer_tpu.engine.renderer import render_chunk as jax_render_chunk
from gpu_raytracer_tpu.models.scene import build_default_scene as jax_default
from gpu_raytracer_tpu.ops.pallas.render import pallas_render_primary
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.engine.renderer import (Renderer, light_seed, light_uniforms,
                                                     tiled_pixel_order)
from gpu_raytracer_tpu_torch.ops.render import render_chunk
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.models.camera import CameraController
from gpu_raytracer_tpu_torch.ops.cuda.render import MAX_LIGHTS, pack_render_tables, render_primary
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene
from gpu_raytracer_tpu_torch.ops.shading import sample_light_index
from gpu_raytracer_tpu_torch.ops.trace import trace
from gpu_raytracer_tpu_torch.reference import cpu_tracer as oracle

TOL = 1e-5
MAX_COUNTED_SHARE = 0.01   # counted rounding-sensitive pixels, share of a frame

_JAX_SCENES = {"default": jax_default, "courtyard2000": lambda: jax_courtyard(2000, seed=1)}


@pytest.fixture(scope="module")
def scene_pairs():
    out = {}
    for name, fn in _JAX_SCENES.items():
        js = fn()
        out[name] = (js, port_scene_from_jax(js))
    return out


def _counted(ps, W, H, shadows=False, sky=(0.0, 0.0, 0.0)):
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(ps.camera, W, H, px.reshape(-1), py.reshape(-1))
    flips = f16_attenuation_flips(ps, trace(ps, o, d)).reshape(H, W)
    return flips | rounding_sensitive_pixels(ps, W, H, shadows=shadows, sky=sky)


def _assert_close(got, want, counted):
    diff = np.abs(got - want).max(axis=-1)
    assert counted.sum() <= MAX_COUNTED_SHARE * counted.size, f"{counted.sum()} counted pixels"
    off = diff[~counted].max()
    assert off <= TOL, f"max |diff| {off:.3g} outside {counted.sum()} counted pixels"


@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("size", [(32, 32), (64, 48)])
@pytest.mark.parametrize("name", sorted(_JAX_SCENES))
def test_frame_matches_jax_renderer(scene_pairs, name, size, shadows):
    js, ps = scene_pairs[name]
    W, H = size
    want = JaxRenderer(js, W, H, shadows=shadows).render()
    got = Renderer(ps, W, H, shadows=shadows, device="cpu").render()
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.max() > 0.05
    _assert_close(got, want, _counted(ps, W, H, shadows))


def test_sky_colour_matches_jax(scene_pairs):
    js, ps = scene_pairs["default"]
    sky = (0.25, 0.5, 0.75)
    want = JaxRenderer(js, 40, 24, sky=sky).render()
    got = Renderer(ps, 40, 24, sky=sky, device="cpu").render()
    assert (got == np.float32(0.75)).any()
    _assert_close(got, want, _counted(ps, 40, 24, sky=sky))


def test_frame_matches_the_interpreted_tpu_kernel(scene_pairs):
    """The fused Pallas kernel, run by the interpreter as
    tests/test_pallas_render.py runs it, on the courtyard with shadows."""
    js, ps = scene_pairs["courtyard2000"]
    W = H = 32
    px, py = tiled_pixel_order(W, H, 32)
    want = np.asarray(pallas_render_primary(js, jnp.asarray(px), jnp.asarray(py), W, H,
                                            shadows=True, packet_size=1024, interpret=True))
    got = render_chunk(ps, torch.from_numpy(px), torch.from_numpy(py), W, H,
                       shadows=True).numpy()
    assert np.abs(got - want).max() <= TOL


def test_frame_matches_the_numpy_oracle(scene_pairs):
    _, ps = scene_pairs["default"]
    W = H = 24
    want = oracle.render(oracle.scene_dict_from(ps), W, H)
    got = Renderer(ps, W, H, device="cpu").render()
    rmse = float(np.sqrt(np.mean((got.astype(np.float64) - want) ** 2)))
    assert rmse <= 1e-5, rmse


def test_tile_major_order_covers_every_pixel_once():
    px, py = tiled_pixel_order(130, 70)
    assert px.shape == (130 * 70,)
    assert len(set(zip(px.tolist(), py.tolist()))) == 130 * 70
    assert (px[:64] == np.arange(64)).all() and (py[:64] == 0).all()
    assert (py[:64 * 64] < 64).all() and (px[:64 * 64] < 64).all()


def test_render_u8_is_the_srgb_quantised_frame(scene_pairs):
    _, ps = scene_pairs["default"]
    r = Renderer(ps, 32, 32, device="cpu")
    u8 = r.render_u8()
    assert u8.dtype == np.uint8 and u8.shape == (32, 32, 3)
    lin = r.render_u8(srgb=False)
    want = (np.clip(r.render(), 0, 1) * 255 + 0.5).astype(np.uint8)
    assert np.array_equal(lin, want)
    assert (u8.astype(int) >= lin.astype(int)).all()


def test_set_camera_renders_the_moved_view(scene_pairs):
    from gpu_raytracer_tpu_torch.models.camera import CameraController

    _, ps = scene_pairs["courtyard2000"]
    r = Renderer(ps, 32, 24, device="cpu")
    before = r.render()
    ctrl = CameraController(ps.camera)
    ctrl.move(forward=3.0, strafe=1.0)
    ctrl.rotate(20.0, 0.0)
    r.set_camera(ctrl.camera())
    moved = r.render()
    fresh = Renderer(ps.with_camera(ctrl.camera()), 32, 24, device="cpu").render()
    assert np.array_equal(moved, fresh) and not np.array_equal(moved, before)


# ---- more than MAX_LIGHTS lights ----

@pytest.fixture(scope="module")
def many_lights():
    js = jax_courtyard(1500, seed=3, lights=64)
    ps = port_scene_from_jax(js)
    assert ps.lights.count == 64 > MAX_LIGHTS
    px, py = tiled_pixel_order(32, 32, 32)
    return js, ps, px, py


@pytest.mark.parametrize("shadows", [False, True])
def test_many_lights_render_every_light_on_the_cpu(many_lights, shadows):
    """64 lights on the CPU: `Renderer` and `render_chunk` loop over every
    light, as the JAX package's `render_chunk` does."""
    js, ps, px, py = many_lights
    W = H = 32
    want = np.asarray(jax_render_chunk(js, jnp.asarray(px), jnp.asarray(py), W, H,
                                       shadows=shadows))
    got = render_chunk(ps, torch.from_numpy(px), torch.from_numpy(py), W, H,
                       shadows=shadows).numpy()
    frame = Renderer(ps, W, H, shadows=shadows, device="cpu").render()
    assert np.array_equal(frame[py, px], got) and got.max() > 1.0
    _assert_close(frame, _to_frame(want, px, py, W, H), _counted(ps, W, H, shadows))


def _to_frame(flat, px, py, W, H):
    fb = np.zeros((H, W, 3), np.float32)
    fb[py, px] = flat
    return fb


def _light_u(n, seed):
    return np.random.default_rng(seed).random(n, dtype=np.float32)


@pytest.mark.parametrize("shadows", [False, True])
def test_sampled_light_frame_matches_the_interpreted_tpu_kernel(many_lights, shadows):
    js, ps, px, py = many_lights
    W = H = 32
    u = _light_u(W * H, 9)
    want = np.asarray(pallas_render_primary(js, jnp.asarray(px), jnp.asarray(py), W, H,
                                            shadows=shadows, packet_size=1024, interpret=True,
                                            light_u=jnp.asarray(u)))
    got = render_chunk(ps, torch.from_numpy(px), torch.from_numpy(py), W, H, shadows=shadows,
                       light_u=torch.from_numpy(u)).numpy()
    assert (np.abs(got - want) <= TOL * np.maximum(1.0, np.abs(want))).all()
    exact = render_chunk(ps, torch.from_numpy(px), torch.from_numpy(py), W, H, shadows=shadows)
    assert not np.array_equal(got, exact.numpy())
    # the wrapper's plain version on the CPU is the same function
    wrapped = render_primary(pack_render_tables(ps), torch.from_numpy(px), torch.from_numpy(py),
                             W, H, shadows=shadows, light_u=torch.from_numpy(u))
    assert np.array_equal(wrapped.numpy(), got)


def test_sampled_light_mean_converges_to_the_loop(many_lights):
    _, ps, px, py = many_lights
    W = H = 32
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    exact = render_chunk(ps, tpx, tpy, W, H, shadows=True).numpy()
    mean = sum(render_chunk(ps, tpx, tpy, W, H, shadows=True,
                            light_u=torch.from_numpy(_light_u(W * H, 100 + k))).numpy()
               for k in range(8)) / 8
    assert np.isfinite(mean).all()
    assert abs(mean.sum() - exact.sum()) / exact.sum() < 0.08


def test_light_choice_is_floor_of_u_times_the_count(many_lights, scene_pairs):
    _, ps, px, py = many_lights
    u = torch.tensor([0.0, 1.0 / 64, 0.4999, 0.5, 0.99999994])
    assert sample_light_index(ps, u).tolist() == [0, 1, 31, 32, 63]
    # one light: nothing to choose, the loop is taken and light_u changes nothing
    _, demo = scene_pairs["default"]
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    assert torch.equal(render_chunk(demo, tpx, tpy, 32, 32, shadows=True,
                                    light_u=torch.from_numpy(_light_u(1024, 1))),
                       render_chunk(demo, tpx, tpy, 32, 32, shadows=True))


def test_wrappers_check_light_u(many_lights):
    _, ps, px, py = many_lights
    tables = pack_render_tables(ps)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    with pytest.raises(ValueError, match="light_u"):
        render_primary(tables, tpx, tpy, 32, 32, light_u=torch.zeros(7))
    with pytest.raises(ValueError, match="light_u"):
        render_primary(tables, tpx, tpy, 32, 32, light_u=torch.zeros(1024, dtype=torch.float64))
    r = Renderer(ps, 32, 32, device="cpu")
    assert r._light_u(1024) is None and r.light_frame == 0   # the CPU route loops


# ---- the light choice's salt and the camera move (their card cases: test_torch_cuda.py) ----

def test_light_seed_is_injective_over_frames_and_salts():
    """The seed of (frame, salt) keeps both whole (32 bits each): batches of
    one frame and one batch of different frames never share a seed."""
    values = [0, 1, 2, 7, 2**31 - 1, 2**31, 2**32 - 1]
    seeds = {light_seed(f, s) for f in values for s in values}
    assert len(seeds) == len(values) ** 2 and all(0 <= x < 2**64 for x in seeds)
    # the low 32 bits (all the CPU generator keeps) also differ here
    assert len({x & 0xFFFFFFFF for x in seeds}) == len(seeds)
    assert light_seed(3, 0) != light_seed(0, 3) and light_seed(1, 0) != light_seed(0, 1 << 32)
    assert light_seed(5, -1) == light_seed(5, 2**32 - 1)   # a salt is taken modulo 2^32


def test_light_uniforms_follow_frame_and_salt():
    n = 4096
    a = light_uniforms(n, 3, 1, "cpu")
    assert a.dtype == torch.float32 and a.shape == (n,)
    assert ((a >= 0.0) & (a < 1.0)).all()
    assert torch.equal(a, light_uniforms(n, 3, 1, "cpu"))
    for frame, salt in ((3, 0), (3, 2), (4, 1), (1, 3)):
        assert not torch.equal(a, light_uniforms(n, frame, salt, "cpu")), (frame, salt)


@pytest.mark.parametrize("salt", [0, 5])
def test_sampled_frames_of_a_salt_average_to_the_loop(many_lights, salt):
    """64 lights: frames 0..7 of one batch salt, each light chosen from
    light_uniforms, average toward the loop over every light (8%, the bar
    of tests/test_pallas_render.py)."""
    _, ps, px, py = many_lights
    W = H = 32
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    exact = render_chunk(ps, tpx, tpy, W, H, shadows=True)
    mean = sum(render_chunk(ps, tpx, tpy, W, H, shadows=True,
                            light_u=light_uniforms(W * H, k, salt, "cpu"))
               for k in range(8)) / 8
    assert torch.isfinite(mean).all()
    assert abs(mean.sum().item() - exact.sum().item()) / exact.sum().item() < 0.08


def _moved(camera):
    ctrl = CameraController(camera)
    ctrl.move(forward=2.0, strafe=-1.0)
    ctrl.rotate(-15.0, 5.0)
    return ctrl.camera()


def test_set_camera_rewrites_the_camera_row_only():
    """A camera move keeps every table tensor (the camera row too, rewritten
    in place) and gives the frame and the camera row of a renderer built at
    the new camera."""
    scene = make_courtyard_scene(2000, seed=1, textured=True)
    r = Renderer(scene, 32, 24, shadows=True, device="cpu")
    t = r.tables
    before = dict(trace=t.trace, nodes=t.trace.nodes, tris=t.trace.tris, attrs=t.trace.attrs,
                  camera=t.camera, materials=t.materials, lights=t.lights, spheres=t.spheres)
    cam = _moved(scene.camera)
    r.set_camera(cam)
    after = dict(trace=r.tables.trace, nodes=r.tables.trace.nodes, tris=r.tables.trace.tris,
                 attrs=r.tables.trace.attrs, camera=r.tables.camera,
                 materials=r.tables.materials, lights=r.tables.lights,
                 spheres=r.tables.spheres)
    assert r.tables is t and all(after[k] is before[k] for k in before)
    fresh = Renderer(scene.with_camera(cam), 32, 24, shadows=True, device="cpu")
    assert torch.equal(t.camera, fresh.tables.camera) and t.fov_scale == fresh.tables.fov_scale
    assert r.scene.camera is t.scene.camera and torch.equal(r.scene.camera.fov, cam.fov)
    assert np.array_equal(r.render(), fresh.render())
