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
from gpu_raytracer_tpu.ops.pallas.render import pallas_render_deferred
from gpu_raytracer_tpu.ops.pallas.texshade import pallas_texture_shade
from gpu_raytracer_tpu.ops.shading import shade_deferred as jax_shade_deferred
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from test_texshade import _random_gbuffer, _textured_scene

from chip_smoke import synthetic_textured_scene
from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.engine.renderer import (Renderer, render_deferred_chunk,
                                                     render_gbuffer, split_gbuffer,
                                                     tiled_pixel_order)
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.shading import shade_deferred
from gpu_raytracer_tpu_torch.ops.trace import trace

TOL = 1e-5
KERNEL_TOL = 2e-5
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
