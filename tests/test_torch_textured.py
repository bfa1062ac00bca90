"""The port's textured render (plain path, on the CPU) against the JAX
package: its deferred shade (XLA), its texture-shade and deferred-trace TPU
kernels run by the Pallas interpreter, and its chunked `Renderer`.

Tolerances:
  * the port's `shade_deferred` against the JAX one: <= 1e-5, NaN lanes
    (ior-1 glass, 0/0 in the dispersion blend) in the same places;
  * against the interpreted texture-shade kernel: <= 2e-5, the JAX
    package's own bar for that kernel against its XLA shade
    (tests/test_texshade.py): the kernel factors the shade as
    albedo*(0.1*occ + brdf*S) + emission, the port keeps the XLA order
    albedo*0.1*occ + (albedo*brdf)*S + emission;
  * the G-buffer against the interpreted deferred trace: material ids
    equal, light sum and uv <= 1e-5, mip footprint <= 1e-5 relative, on
    hit lanes (the kernel leaves a miss lane's light sum undefined);
  * frames: <= 1e-5.
  * the fused textured render (`render_primary` on a textured scene, the
    plain version of the textured single-phase kernel): <= 3e-4 against the
    interpreted TPU kernel, the bar tests/test_pallas_render.py states for
    it (its atlas planes are bf16 and its sphere uvs come from a polynomial
    atan2), and <= 1e-5 against the JAX package's `render_chunk`; with 64
    lights and the same `light_u` from NumPy the sampled light sum of the
    deferred trace within 1e-5 relative to max(1, value).
Frames and G-buffers may exceed their bound only at counted pixels where
the evaluation order can matter (tests/torch_bridge.py): an f16
attenuation on a rounding boundary, f32 rounding alone moving the pixel by
more than 1e-6 from a float64 evaluation (sphere pixels of a textured
sphere, whose uv the TPU kernel takes from a polynomial atan2 and its
normal from an approximate rsqrt), or a nearest mip level on a level
boundary. Such exceptions may be at most 1% of a frame."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import (f16_attenuation_flips, mip_flip_pixels, port_scene_from_jax,
                          rounding_sensitive_pixels)

from gpu_raytracer_tpu.config import RaytracerConfig as JaxConfig
from gpu_raytracer_tpu.engine.renderer import Renderer as JaxRenderer
from gpu_raytracer_tpu.models.geometry import Textures as JaxTextures
from gpu_raytracer_tpu.engine.renderer import render_chunk as jax_render_chunk
from gpu_raytracer_tpu.ops.pallas.render import pallas_render_deferred, pallas_render_primary
from gpu_raytracer_tpu.ops.pallas.texshade import pallas_texture_shade
from gpu_raytracer_tpu.ops.shading import shade_deferred as jax_shade_deferred
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu.utils.procgen import make_zoo_scene as jax_zoo
from test_texshade import _random_gbuffer, _textured_scene

from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.engine.renderer import Renderer, tiled_pixel_order
from gpu_raytracer_tpu_torch.ops.render import (gbuffer_planes, render_deferred_chunk,
                                                render_gbuffer, split_gbuffer)
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.cuda.render import (pack_render_tables, render_deferred,
                                                     render_primary)
from gpu_raytracer_tpu_torch.ops.shading import shade_deferred
from gpu_raytracer_tpu_torch.ops.trace import trace

TOL = 1e-5
KERNEL_TOL = 2e-5
FUSED_KERNEL_TOL = 3e-4
MAX_COUNTED_SHARE = 0.01
SKY = (0.1, 0.2, 0.3)


def _synthetic_pair(seed, mips=1, **kw):
    """The JAX texture-shade test scene and the port's copy of it, carried
    across; with mips > 1 both get the same images as mip pyramids."""
    js = _textured_scene(np.random.default_rng(seed), **kw)
    if mips > 1:
        rng = np.random.default_rng(seed)
        imgs = [rng.integers(0, 256, size=(5 + 3 * i, 9 + 11 * i, 4), dtype=np.uint8)
                for i in range(3)]
        js = dataclasses.replace(js, textures=JaxTextures.from_images(imgs, wrap=[0, 1, 2],
                                                                      mips=mips))
    return js, port_scene_from_jax(js)


def _gbuffer_inputs(rng, n_mats, B=2, sub=64, mips=False):
    out7, light, mat_id, uv = _random_gbuffer(rng, B=B, sub=sub, n_mats=n_mats)
    N = B * sub * 128
    lam = (np.exp2(rng.uniform(-10.0, 0.0, N)) if mips else np.zeros(N)).astype(np.float32)
    out7 = np.ascontiguousarray(out7)
    out7[:, 6] = lam.reshape(B, sub, 128)
    return out7, light, mat_id, uv, lam


def _port_shade(ps, light, mat_id, uv, lam, trilinear=False, sky=SKY):
    return shade_deferred(ps, torch.from_numpy(light), torch.from_numpy(mat_id.astype(np.int64)),
                          torch.from_numpy(uv), sky_color=sky, lam=torch.from_numpy(lam),
                          trilinear=trilinear).numpy()


def _assert_close(diff, counted, tol=TOL):
    """Every value beyond `tol` is at a counted pixel, and such exceptions
    are at most MAX_COUNTED_SHARE of the frame."""
    bad = diff > tol
    assert not (bad & ~counted).any(), f"max |diff| {diff[~counted].max():.3g} uncounted"
    assert bad.sum() <= MAX_COUNTED_SHARE * bad.size, f"{bad.sum()} exceptions"


def _assert_same_with_nans(got, want, tol):
    """NaN and infinite values in the same places (with the same sign), the
    rest within tol."""
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=tol)


@pytest.mark.parametrize("case", ["full", "degenerate_glass", "many_materials",
                                  "mips_nearest", "mips_trilinear"])
def test_shade_deferred_matches_jax(case):
    n_mats = 256 if case == "many_materials" else 6
    mips = 4 if case.startswith("mips") else 1
    trilinear = case == "mips_trilinear"
    js, ps = _synthetic_pair(0, mips=mips, n_mats=n_mats,
                             degenerate_glass=case == "degenerate_glass")
    _, light, mat_id, uv, lam = _gbuffer_inputs(np.random.default_rng(1), n_mats,
                                                mips=mips > 1)
    want = np.asarray(jax_shade_deferred(js, jnp.asarray(light), jnp.asarray(mat_id),
                                         jnp.asarray(uv), sky_color=SKY, lam=jnp.asarray(lam),
                                         trilinear=trilinear))
    got = _port_shade(ps, light, mat_id, uv, lam, trilinear)
    assert got.shape == want.shape and got.dtype == np.float32
    _assert_same_with_nans(got, want, TOL)
    if case == "degenerate_glass":
        assert np.isnan(got).any()
    else:
        assert np.isfinite(got).all()
    assert (got[mat_id < 0] == np.float32(SKY)).all()
    assert (got[mat_id >= n_mats] == np.asarray([1.0, 0.0, 1.0], np.float32)).all()


@pytest.mark.parametrize("case", ["full", "degenerate_glass", "mips_nearest", "mips_trilinear"])
def test_shade_deferred_matches_the_interpreted_tpu_kernel(case):
    mips = 4 if case.startswith("mips") else 1
    trilinear = case == "mips_trilinear"
    js, ps = _synthetic_pair(2, mips=mips, degenerate_glass=case == "degenerate_glass")
    out7, light, mat_id, uv, lam = _gbuffer_inputs(np.random.default_rng(3), 6, B=1, sub=16,
                                                   mips=mips > 1)
    want = np.asarray(pallas_texture_shade(js, jnp.asarray(out7), sky=SKY, interpret=True,
                                           trilinear=trilinear))
    got = _port_shade(ps, light, mat_id, uv, lam, trilinear)
    _assert_same_with_nans(got, want, KERNEL_TOL)


_DEFERRED_SCENES = {
    "courtyard2000": lambda: jax_courtyard(2000, seed=1, textured=True),
    "synthetic": lambda: _synthetic_pair(4, mips=4)[0],    # live spheres: sphere uvs
}


@pytest.fixture(scope="module")
def interpreted_deferred():
    """JAX's deferred trace kernel (interpreted) on a 32x32 frame of each
    scene, shadows on, as its G-buffer [N,7] and its out7 kernel layout."""
    W = H = 32
    px, py = tiled_pixel_order(W, H, 32)
    out = {}
    for name, fn in _DEFERRED_SCENES.items():
        js = fn()
        flat = np.asarray(pallas_render_deferred(js, jnp.asarray(px), jnp.asarray(py), W, H,
                                                 shadows=True, packet_size=1024,
                                                 interpret=True, return_gbuffer=True))
        out[name] = (js, port_scene_from_jax(js), flat)
    return out, torch.from_numpy(px), torch.from_numpy(py), W, H


@pytest.mark.parametrize("name", sorted(_DEFERRED_SCENES))
def test_gbuffer_matches_the_interpreted_tpu_kernel(interpreted_deferred, name):
    scenes, px, py, W, H = interpreted_deferred
    _, ps, want = scenes[name]
    S, mat, uv, lam = split_gbuffer(render_gbuffer(ps, px, py, W, H, shadows=True))
    assert np.array_equal(mat.numpy(), want[:, 3].astype(np.int64))
    hit = mat.numpy() >= 0
    assert 0 < hit.sum() < hit.size
    counted = _counted(ps, W, H, shadows=True, sky=SKY).reshape(-1)[_frame_index(px, py, W)]
    for got, ref in ((S.numpy(), want[:, 0:3]), (uv.numpy(), want[:, 4:6])):
        _assert_close(np.where(hit[:, None], np.abs(got - ref), 0.0).max(axis=1), counted)
    rel = np.abs(lam.numpy() - want[:, 6]) / np.maximum(np.abs(want[:, 6]), 1e-30)
    _assert_close(np.where(hit, rel, 0.0), counted)
    assert (uv.numpy()[~hit] == 0).all()
    # the synthetic scene's triangles carry no uvs: footprint 0, level 0
    assert (lam.numpy()[hit] > 0).any() == (name == "courtyard2000")


@pytest.mark.parametrize("name", sorted(_DEFERRED_SCENES))
def test_deferred_frame_matches_the_interpreted_tpu_kernels(interpreted_deferred, name):
    """The plain two-phase render against JAX's deferred trace kernel
    followed by its texture-shade kernel, both interpreted."""
    scenes, px, py, W, H = interpreted_deferred
    js, ps, flat = scenes[name]
    out7 = flat.reshape(1, 8, 128, 7).transpose(0, 3, 1, 2)
    want = np.asarray(pallas_texture_shade(js, jnp.asarray(out7), sky=SKY, interpret=True))
    got = render_deferred_chunk(ps, px, py, W, H, shadows=True, sky=SKY).numpy()
    counted = _counted(ps, W, H, shadows=True, sky=SKY).reshape(-1)[_frame_index(px, py, W)]
    _assert_close(np.abs(got - want).max(axis=1), counted)


def _frame_index(px, py, W):
    """Row-major frame index of each ray of a tile-ordered batch."""
    return py.numpy() * W + px.numpy()


def _counted(ps, W, H, shadows=False, sky=(0.0, 0.0, 0.0), trilinear=False):
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(ps.camera, W, H, px.reshape(-1), py.reshape(-1))
    hit = trace(ps, o, d)
    flips = f16_attenuation_flips(ps, hit) | (mip_flip_pixels(ps, hit, H) if not trilinear
                                              else False)
    sensitive = rounding_sensitive_pixels(ps, W, H, shadows=shadows, sky=sky,
                                          trilinear=trilinear)
    return flips.reshape(H, W) | sensitive


@pytest.fixture(scope="module")
def courtyard_pair():
    js = jax_courtyard(2000, seed=1, textured=True)
    return js, port_scene_from_jax(js)


@pytest.mark.parametrize("trilinear", [False, True])
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("size", [(32, 32), (64, 48)])
def test_textured_frame_matches_jax_renderer(courtyard_pair, size, shadows, trilinear):
    js, ps = courtyard_pair
    W, H = size
    want = JaxRenderer(js, W, H, shadows=shadows,
                       config=JaxConfig(texture_trilinear=trilinear)).render()
    got = Renderer(ps, W, H, shadows=shadows, device="cpu",
                   config=RaytracerConfig(texture_trilinear=trilinear)).render()
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.max() > 0.05
    counted = _counted(ps, W, H, shadows, trilinear=trilinear)
    _assert_close(np.abs(got - want).max(axis=-1), counted)


def test_textured_courtyard_renders_texels():
    """Textures change the frame: the textured courtyard is not the
    untextured one with other colours everywhere; its floor shows the
    checker's two tones."""
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    r = Renderer(make_courtyard_scene(2000, seed=1, textured=True), 64, 48, device="cpu")
    img = r.render()
    floor = img[40:, :, 0]
    assert np.isfinite(img).all() and floor.max() > 2.0 * max(floor.min(), 1e-3)


# ---- the fused textured render (the textured single-phase kernel's plain version) ----

def _random_mesh_scene():
    """The scene of tests/test_pallas_render.py's single-phase textured
    parity test: 300 random triangles with random uvs, 3 materials over two
    small textures, one with occlusion and emissive maps."""
    from gpu_raytracer_tpu.models.camera import Camera
    from gpu_raytracer_tpu.models.geometry import Mesh, Spheres
    from gpu_raytracer_tpu.models.light import LightBuilder
    from gpu_raytracer_tpu.models.material import MaterialBuilder
    from gpu_raytracer_tpu.models.scene import prepare_scene

    rng = np.random.default_rng(31)
    imgs = [rng.integers(0, 256, size=(7, 6, 4), dtype=np.uint8),
            rng.integers(0, 256, size=(4, 10, 4), dtype=np.uint8)]
    mb = MaterialBuilder()
    for i in range(3):
        ti = np.full(8, 0xFFFFFFFF, np.uint32)
        ti[0] = i % 2
        if i == 1:
            ti[3] = 1    # occlusion
            ti[4] = 0    # emissive
        mb.add(albedo=rng.uniform(0.3, 1.0, 3), metallic=float(i == 2), roughness=0.5,
               emission=rng.uniform(0, 0.4, 3), texture_indices=ti)
    lb = LightBuilder()
    lb.add_point((2.0, 5.0, 4.0), (1.0, 1.0, 0.9), 3.0, float("inf"))
    verts = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    idx = rng.integers(0, 500, (300, 3)).astype(np.uint32)
    uvs = rng.uniform(-1, 2, (500, 2)).astype(np.float32)
    mesh = Mesh.from_arrays(verts, idx, rng.integers(0, 3, 300).astype(np.uint32), uv=uvs)
    return prepare_scene(Camera.default(), Spheres.from_rows([]), mesh, mb.build(), lb.build(),
                         textures=JaxTextures.from_images(imgs))


_FUSED_SCENES = {
    "random_mesh": (_random_mesh_scene, 64),
    "zoo800_multi_slot": (lambda: jax_zoo(800, seed=0, multi_slot=True), 64),
    "synthetic_spheres": (lambda: _synthetic_pair(4, mips=4)[0], 32),
}


@pytest.fixture(scope="module")
def fused_pairs():
    return {name: (js, port_scene_from_jax(js), size)
            for name, (js, size) in ((n, (fn(), size)) for n, (fn, size) in _FUSED_SCENES.items())}


@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("name", sorted(_FUSED_SCENES))
def test_textured_render_primary_matches_jax(fused_pairs, name, shadows):
    """`render_primary` on a textured scene renders it textured (it was
    untextured on the card and textured on the CPU): against the JAX
    package's interpreted single-phase kernel and its `render_chunk`."""
    js, ps, size = fused_pairs[name]
    W = H = size
    px, py = tiled_pixel_order(W, H, 64)
    jpx, jpy = jnp.asarray(px), jnp.asarray(py)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    got = render_primary(pack_render_tables(ps), tpx, tpy, W, H, shadows=shadows,
                         sky=SKY).numpy()
    kernel = np.asarray(pallas_render_primary(js, jpx, jpy, W, H, shadows=shadows, sky=SKY,
                                              packet_size=1024, interpret=True))
    counted = _counted(ps, W, H, shadows, sky=SKY).reshape(-1)[_frame_index(tpx, tpy, W)]
    _assert_close(np.abs(got - kernel).max(axis=1), counted, FUSED_KERNEL_TOL)
    chunk = np.asarray(jax_render_chunk(js, jpx, jpy, W, H, shadows=shadows, sky=SKY))
    _assert_close(np.abs(got - chunk).max(axis=1), counted)
    flat = dataclasses.replace(ps, textures=type(ps.textures).empty())
    untextured = render_primary(pack_render_tables(flat), tpx, tpy, W, H, shadows=shadows,
                                sky=SKY).numpy()
    assert np.abs(got - untextured).max() > 0.01   # the maps are in the frame


@pytest.fixture(scope="module")
def many_lights_textured():
    js = jax_courtyard(1500, seed=3, lights=64, textured=True)
    px, py = tiled_pixel_order(32, 32, 32)
    u = np.random.default_rng(9).random(1024, dtype=np.float32)
    return js, port_scene_from_jax(js), px, py, u


@pytest.mark.parametrize("shadows", [False, True])
def test_sampled_light_textured_frame_matches_the_interpreted_tpu_kernel(many_lights_textured,
                                                                         shadows):
    js, ps, px, py, u = many_lights_textured
    W = H = 32
    want = np.asarray(pallas_render_primary(js, jnp.asarray(px), jnp.asarray(py), W, H,
                                            shadows=shadows, packet_size=1024, interpret=True,
                                            light_u=jnp.asarray(u)))
    got = render_primary(pack_render_tables(ps), torch.from_numpy(px), torch.from_numpy(py),
                         W, H, shadows=shadows, light_u=torch.from_numpy(u)).numpy()
    assert (np.abs(got - want) <= FUSED_KERNEL_TOL * np.maximum(1.0, np.abs(want))).all()


@pytest.mark.parametrize("shadows", [False, True])
def test_sampled_light_gbuffer_matches_the_interpreted_tpu_kernel(many_lights_textured, shadows):
    js, ps, px, py, u = many_lights_textured
    W = H = 32
    want = np.asarray(pallas_render_deferred(js, jnp.asarray(px), jnp.asarray(py), W, H,
                                             shadows=shadows, packet_size=1024, interpret=True,
                                             light_u=jnp.asarray(u), return_gbuffer=True))
    tpx, tpy, tu = torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(u)
    gbuf = render_deferred(pack_render_tables(ps), tpx, tpy, W, H, shadows=shadows, light_u=tu)
    plain = gbuffer_planes(render_gbuffer(ps, tpx, tpy, W, H, shadows=shadows, light_u=tu))
    assert torch.equal(gbuf.view(torch.int32), plain.view(torch.int32))   # a miss's id is NaN bits
    S, mat, _, _ = split_gbuffer(gbuf)
    hit = mat.numpy() >= 0
    assert np.array_equal(mat.numpy(), want[:, 3].astype(np.int64))
    ok = np.abs(S.numpy() - want[:, :3]) <= TOL * np.maximum(1.0, np.abs(want[:, :3]))
    assert ok[hit].all() and S.numpy()[hit].max() > 1.0
    # the two-phase frame from that G-buffer equals the fused one to a few ulp
    two_phase = render_deferred_chunk(ps, tpx, tpy, W, H, shadows=shadows, light_u=tu)
    fused = render_primary(pack_render_tables(ps), tpx, tpy, W, H, shadows=shadows, light_u=tu)
    assert (two_phase - fused).abs().max().item() <= TOL * max(1.0, fused.max().item())
