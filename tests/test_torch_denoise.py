"""The port's à-trous denoiser (ops/denoise.py) and the path tracer's
G-buffer against the JAX package (mirrors tests/test_denoise.py).

Tolerances:
  * `atrous_denoise` on the same inputs: assert_allclose(rtol=1e-5,
    atol=1e-6). The port stacks the 25 taps of a pass and reduces over the
    stack where JAX adds them one after another, and XLA:CPU contracts
    multiply-adds: both move the result by rounding only. The inputs are
    shaped like a path tracer's frame (radiance times an albedo in [0, 1],
    albedo 1 and normal 0 on misses), and the path tracer's own: its
    G-buffer and a path-traced frame of the textured courtyard, with the
    albedo as it comes and stretched down to 0;
  * `gbuffer()`: normal, depth (relative) and albedo <= 1e-5, except at
    counted pixels where JAX's hit point or uv differs from the port's by
    rounding alone: the same primitive, and the port's point and uv within
    1e-5 relative of JAX's on every hit (asserted; the barycentrics
    cancel, and XLA:CPU contracts their multiply-adds). A sphere normal is
    (point - centre) / radius, and a 256-texel map's bilinear gradient
    turns an ulp of uv into up to 1e-4 of albedo. Given JAX's own uv and
    material, the two samplers agree within 1e-5 (at most 1% of the hits
    counted; none on these scenes); what is left are JAX's jit-compiled
    G-buffer differing from its own trace and sampler (XLA fuses and
    contracts them). At most 2% of a frame: measured 0.52% (default, 2
    normals) and 1.17% (textured courtyard, 36 albedos: 32 uvs an ulp
    apart, 4 where JAX's jitted sampler differs from its eager one).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu import build_default_scene as jax_default_scene
from gpu_raytracer_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from gpu_raytracer_tpu.engine.pathtracer import PathTracer as JaxPathTracer
from gpu_raytracer_tpu.ops.camera_rays import generate_rays as jax_generate_rays
from gpu_raytracer_tpu.ops.camera_rays import pixel_grid
from gpu_raytracer_tpu.ops.denoise import atrous_denoise as jax_atrous_denoise
from gpu_raytracer_tpu.ops.trace import trace as jax_trace
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer, primary_gbuffer
from gpu_raytracer_tpu_torch.models.scene import build_default_scene
from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise

TOL = 1e-5
MAX_COUNTED_SHARE = 0.02


def _frame_gbuffer(seed, H, W):
    """A G-buffer and a noisy frame shaped like a path tracer's: a flat
    wall, a quarter of sky (normal 0, depth f32::MAX, albedo 1), the rest
    random normals and depths."""
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[:, : W // 3] = [0.0, 0.0, 1.0]
    normal[: H // 4] = 0.0
    miss = (normal * normal).sum(-1) < 0.25
    depth = rng.uniform(1.0, 10.0, (H, W)).astype(np.float32)
    depth[miss] = np.float32(3.4028235e38)
    albedo = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    albedo[miss] = 1.0
    color = (albedo * rng.exponential(0.5, (H, W, 3))).astype(np.float32)
    return color, normal, depth, albedo


@pytest.mark.parametrize("sigma_normal", [64.0, 37.5])
@pytest.mark.parametrize("with_albedo", [False, True])
@pytest.mark.parametrize("iterations", [1, 4])
@pytest.mark.parametrize("size", [(64, 64), (96, 80)])
def test_atrous_denoise_matches_jax(size, iterations, with_albedo, sigma_normal):
    H, W = size
    color, normal, depth, albedo = _frame_gbuffer(H * W + iterations, H, W)
    alb = albedo if with_albedo else None
    kw = {} if sigma_normal == 64.0 else dict(sigma_normal=sigma_normal)
    want = np.asarray(jax_atrous_denoise(jnp.asarray(color), jnp.asarray(normal),
                                         jnp.asarray(depth),
                                         None if alb is None else jnp.asarray(alb),
                                         iterations=iterations, **kw))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = atrous_denoise(t(color), t(normal), t(depth), t(alb), iterations=iterations, **kw)
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-6)


def test_cos_power_is_repeated_squaring_for_integer_exponents():
    from gpu_raytracer_tpu.ops.denoise import _cos_power as jax_cos_power
    from gpu_raytracer_tpu_torch.ops.denoise import _cos_power

    # cosines of nearby normals: x^100 stays a normal float (XLA:CPU flushes
    # subnormal results to zero, PyTorch keeps them)
    x = np.random.default_rng(0).uniform(0.5, 1.0, 4096).astype(np.float32)
    for e in (1, 3, 64, 100):
        got = _cos_power(torch.from_numpy(x), float(e)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_cos_power(jnp.asarray(x), float(e))))


# ---- properties of the filter (tests/test_denoise.py) on the port ----

def _flat(h, w):
    return (torch.tensor([0.0, 0.0, 1.0]).expand(h, w, 3).contiguous(),
            torch.full((h, w), 5.0))


def test_flat_region_noise_shrinks():
    h = w = 64
    rng = np.random.default_rng(0)
    clean = np.full((h, w, 3), 0.5, np.float32)
    noisy = clean + rng.normal(0, 0.1, clean.shape).astype(np.float32)
    out = atrous_denoise(torch.from_numpy(noisy), *_flat(h, w), iterations=4).numpy()
    assert np.mean((out - clean) ** 2) < np.mean((noisy - clean) ** 2) / 15.0


def test_normal_and_depth_edges_are_preserved():
    h = w = 64
    rng = np.random.default_rng(1)
    left, right = np.float32([0.8, 0.2, 0.2]), np.float32([0.1, 0.1, 0.6])
    clean = np.empty((h, w, 3), np.float32)
    clean[:, : w // 2], clean[:, w // 2:] = left, right
    noisy = clean + rng.normal(0, 0.05, clean.shape).astype(np.float32)
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2], normal[:, w // 2:] = [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]
    out = atrous_denoise(torch.from_numpy(noisy), torch.from_numpy(normal),
                         torch.full((h, w), 5.0), iterations=4).numpy()
    assert np.allclose(out[:, w // 2 - 1].mean(axis=0), left, atol=0.03)
    assert np.allclose(out[:, w // 2].mean(axis=0), right, atol=0.03)
    step = np.empty((h, w, 3), np.float32)
    step[: h // 2], step[h // 2:] = 0.9, 0.15
    depth = np.full((h, w), 2.0, np.float32)
    depth[h // 2:] = 10.0
    noisy = step + rng.normal(0, 0.05, step.shape).astype(np.float32)
    out = atrous_denoise(torch.from_numpy(noisy), _flat(h, w)[0], torch.from_numpy(depth),
                         iterations=4).numpy()
    assert abs(out[: h // 2].mean() - 0.9) < 0.03 and abs(out[h // 2:].mean() - 0.15) < 0.03


def test_albedo_detail_survives_demodulation():
    h = w = 64
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (((yy // 4) + (xx // 4)) % 2).astype(np.float32)
    albedo = np.repeat((0.2 + 0.7 * checker)[..., None], 3, axis=-1)
    noisy = albedo * (0.6 + rng.normal(0, 0.08, (h, w, 3)).astype(np.float32))
    out = atrous_denoise(torch.from_numpy(noisy), *_flat(h, w), torch.from_numpy(albedo),
                         iterations=4).numpy()
    assert np.mean((out - albedo * 0.6) ** 2) < np.mean((noisy - albedo * 0.6) ** 2) / 10.0
    assert abs(out[checker > 0.5].mean() / out[checker < 0.5].mean() - 0.9 / 0.2) < 0.2


def test_sky_does_not_bleed():
    h = w = 32
    clean = np.empty((h, w, 3), np.float32)
    clean[: h // 2], clean[h // 2:] = 1.0, 0.05
    normal = np.zeros((h, w, 3), np.float32)
    normal[h // 2:] = [0.0, 1.0, 0.0]
    depth = np.full((h, w), 1e30, np.float32)
    depth[h // 2:] = 3.0
    out = atrous_denoise(torch.from_numpy(clean), torch.from_numpy(normal),
                         torch.from_numpy(depth), iterations=3).numpy()
    assert np.allclose(out[: h // 2], 1.0, atol=1e-5)
    assert np.abs(out[h // 2:] - 0.05).max() < 1e-5


# ---- the path tracer's G-buffer and denoised output ----

GBUF_SCENES = {"default": (jax_default_scene, 24, 16),
               "textured_courtyard3000": (lambda: jax_courtyard(3000, seed=0, textured=True),
                                          64, 48)}


@pytest.fixture(scope="module")
def gbuffers():
    """Per scene: (port planes, JAX planes, port hit, JAX hit, JAX scene,
    port scene)."""
    out = {}
    for name, (make, W, H) in GBUF_SCENES.items():
        js = make()
        ps = port_scene_from_jax(js)
        pp = PathTracer(ps, W, H, device="cpu")
        got = [x.reshape(H * W, -1).numpy() for x in pp.gbuffer()]
        want = [np.asarray(x).reshape(H * W, -1) for x in JaxPathTracer(js, W, H).gbuffer()]
        grid = torch.arange(W * H)
        hit = primary_gbuffer(pp.tables, grid % W, grid // W, W, H)[0]
        px, py = pixel_grid(W, H)
        o, d = jax_generate_rays(js.camera, W, H, px, py)
        jhit = jax_trace(js, o, d, leaf_size=JAX_CONFIG.bvh_leaf_size,
                         use_bvh=js.bvh.num_nodes > 1)
        out[name] = (got, want, hit, jhit, js, ps)
    return out


@pytest.mark.parametrize("name", sorted(GBUF_SCENES))
def test_gbuffer_matches_jax(gbuffers, name):
    got, want, hit, jhit = gbuffers[name][:4]
    n = got[0].shape[0]
    same_prim = (hit.prim_id.numpy() == np.asarray(jhit.prim_id)) & (
        hit.prim_kind.numpy() == np.asarray(jhit.prim_kind))
    assert same_prim.mean() >= 1.0 - MAX_COUNTED_SHARE
    rel = lambda a, b: (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max(axis=-1)
    near = lambda a, b: rel(a.astype(np.float64), np.asarray(b, np.float64)) <= TOL
    # (a) uv / point rounding: on every hit of the same primitive the port's
    # hit point and uv are within 1e-5 of JAX's
    close = near(hit.point.numpy(), jhit.point) & near(hit.uv.numpy(), jhit.uv)
    h = np.asarray(jhit.hit)
    assert (close | ~(same_prim & h)).all(), f"{(same_prim & h & ~close).sum()} hits apart"
    counted = same_prim & close
    bad = np.zeros(n, bool)
    for g, w in zip(got, want):
        bad |= rel(g, w) > TOL
    assert not (bad & ~counted).any(), f"{(bad & ~counted).sum()} pixels off, uncounted"
    assert bad.sum() <= MAX_COUNTED_SHARE * n, f"{bad.sum()} counted pixels of {n}"


@pytest.mark.parametrize("name", sorted(GBUF_SCENES))
def test_gbuffer_sampler_matches_jax_at_the_same_uv(gbuffers, name):
    """(b) The albedo sampler given JAX's own uv and material id: the
    port's `ops/shading.py::sample_materials` against JAX's
    `material_textures` within 1e-5, at most 1% of the hits counted. What
    the G-buffer comparison counts beyond this is rounding of uv (a)."""
    from gpu_raytracer_tpu.ops.shading import material_textures as jax_material_textures
    from gpu_raytracer_tpu_torch.ops.shading import sample_materials

    jhit, js, ps = gbuffers[name][3:]
    h = np.asarray(jhit.hit)
    mid = np.clip(np.asarray(jhit.material_id), 0, None)
    want = np.asarray(jax_material_textures(js, jnp.asarray(mid), jhit.uv)[0])
    got = sample_materials(ps, torch.from_numpy(mid).long(),
                           torch.from_numpy(np.array(jhit.uv))).albedo.numpy()
    rel = (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max(axis=-1)
    off = (rel > TOL) & h
    assert h.sum() > 30
    assert off.sum() <= 0.01 * h.sum(), f"{off.sum()} of {h.sum()} hits past {TOL}"


def _traced_frame(W=64, H=48, spp=4):
    """The port's path-traced frame of the textured courtyard and its own
    G-buffer (the albedo as the scene gives it)."""
    ps = port_scene_from_jax(jax_courtyard(3000, seed=0, textured=True))
    pt = PathTracer(ps, W, H, device="cpu")
    for _ in range(spp):
        pt.step()
    normal, depth, albedo = (x.numpy() for x in pt.gbuffer())
    return pt.image_device().numpy(), normal, depth, albedo


@pytest.fixture(scope="module")
def traced_frame():
    return _traced_frame()


@pytest.mark.parametrize("albedo_range", ["as_it_comes", "down_to_0"])
@pytest.mark.parametrize("iterations", [1, 4])
def test_atrous_denoise_matches_jax_on_a_path_traced_frame(traced_frame, albedo_range,
                                                           iterations):
    """The filter on the path tracer's own G-buffer and radiance: no element
    past rtol 1e-5 / atol 1e-6, with the courtyard's albedos as they come
    (from 0.11 up) and stretched linearly so the darkest hit is 0."""
    color, normal, depth, albedo = traced_frame
    if albedo_range == "down_to_0":
        hit = depth < 1e30
        lo, hi = albedo[hit].min(), albedo[hit].max()
        albedo = np.where(hit[..., None], (albedo - lo) / (hi - lo) * hi, albedo)
        albedo = albedo.astype(np.float32)
        assert albedo[hit].min() == 0.0
    want = np.asarray(jax_atrous_denoise(jnp.asarray(color), jnp.asarray(normal),
                                         jnp.asarray(depth), jnp.asarray(albedo),
                                         iterations=iterations))
    got = atrous_denoise(*(torch.from_numpy(np.array(a)) for a in (color, normal, depth, albedo)),
                         iterations=iterations)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-6)


def test_gbuffer_shapes_and_miss_convention():
    pt = PathTracer(build_default_scene(), 24, 16, shadows=False, device="cpu")
    normal, depth, albedo = pt.gbuffer()
    assert normal.shape == (16, 24, 3) and depth.shape == (16, 24) and albedo.shape == (16, 24, 3)
    miss = ((normal * normal).sum(-1) < 0.25).numpy()
    assert miss.any() and (~miss).any()
    assert np.allclose(albedo.numpy()[miss], 1.0)
    assert pt.gbuffer()[0] is normal   # cached


def test_denoised_image_end_to_end():
    """denoised_image: the filter over image_device() along gbuffer(), and
    closer to a 48-spp reference than the raw 2-spp mean."""
    scene = build_default_scene()
    pt = PathTracer(scene, 32, 32, shadows=False, seed=3, device="cpu")
    for _ in range(2):
        pt.step()
    raw = pt.image()
    den = pt.denoised_image(iterations=3)
    assert den.shape == (32, 32, 3) and np.isfinite(den).all()
    np.testing.assert_array_equal(den, atrous_denoise(pt.image_device(), *pt.gbuffer(),
                                                      iterations=3).numpy())
    u8 = pt.denoised_frame(iterations=3, u8=True)
    assert u8.dtype == torch.uint8 and u8.shape == (32, 32, 3)
    ref = PathTracer(scene, 32, 32, shadows=False, seed=11, device="cpu")
    for _ in range(48):
        ref.step()
    assert np.mean((den - ref.image()) ** 2) < np.mean((raw - ref.image()) ** 2)
