"""Temporal reprojection (engine/pathtracer.py `_warp_history`,
`set_camera(temporal=True)`) against the JAX package (mirrors
tests/test_temporal.py; the Viewer is not ported yet).

The warp's +-0.5-pixel history jitter is drawn from jax.random in the JAX
package, which PyTorch cannot reproduce: the parity tests inject into the
port the array JAX draws, jax.random.uniform(fold_in(fold_in(key, 0x3A97),
warp_no), (C, 2)).

Tolerances: the warped accumulator within 1e-5 (relative to max(1, value))
on at least 99% of the pixels, the bar of the path tracer's images (the
accumulation it carries differs there, tests/test_torch_pathtracer.py);
the per-pixel history weights equal, except counted pixels whose jittered
projected position lies within 1e-4 pixel of a rounding boundary (at most
0.1% of the frame): another f32 evaluation order (XLA:CPU contracts
multiply-adds) may round those to the neighbouring pixel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu import build_default_scene as jax_default_scene
from gpu_raytracer_tpu.engine.pathtracer import PathTracer as JaxPathTracer
from gpu_raytracer_tpu.models.camera import Camera as JaxCamera
from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer, primary_gbuffer
from gpu_raytracer_tpu_torch.models.camera import Camera
from gpu_raytracer_tpu_torch.models.scene import build_default_scene

W = H = 32
TOL = 1e-5
MIN_SHARE = 0.99
MAX_BOUNDARY_SHARE = 0.001


def _pt(spp=3, **kw):
    kw.setdefault("shadows", False)
    kw.setdefault("antialias", False)
    p = PathTracer(build_default_scene(), W, H, device="cpu", **kw)
    for _ in range(spp):
        p.step()
    return p


def _moved(cam, dp, direction=None):
    return Camera(position=cam.position + torch.tensor(dp, dtype=torch.float32),
                  direction=cam.direction if direction is None else direction,
                  up=cam.up, fov=cam.fov)


def _jax_jitter(jp, warp_no, n):
    key = jax.random.fold_in(jax.random.fold_in(jp.key, 0x3A97), warp_no)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n, 2))))


def _boundary_pixels(pp, old_cam, old_fov_scale, jitter, tol=1e-4):
    """[C] bool: pixels whose jittered projected position, evaluated in
    float64 from the port's new-camera hits, lies within `tol` pixel of a
    rounding boundary."""
    hit, o, d, _ = primary_gbuffer(pp.tables, pp._px, pp._py, pp.width, pp.height)
    f64 = lambda x: x.double()
    point = f64(o) + f64(d) * f64(hit.t)[:, None]
    V = torch.where(hit.hit[:, None], point - f64(old_cam.position), f64(d))
    fwd, up = f64(old_cam.direction), f64(old_cam.up)
    right = torch.linalg.cross(fwd, up)
    true_up = torch.linalg.cross(right, fwd)
    af = V @ fwd / (fwd @ fwd)
    ar = V @ right / (right @ right)
    au = V @ true_up / (true_up @ true_up)
    af = torch.where(af > 1e-6, af, torch.ones_like(af))
    u = ((ar / af) / (pp.width / pp.height * old_fov_scale) + 1.0) * 0.5
    v = (1.0 - (au / af) / old_fov_scale) * 0.5
    x = u * pp.width - 0.5 + (f64(jitter[:, 0]) - 0.5)
    y = v * pp.height - 0.5 + (f64(jitter[:, 1]) - 0.5)
    near = lambda z: (torch.abs(z - torch.floor(z) - 0.5) < tol)
    return (near(x) | near(y)).numpy()


@pytest.fixture(scope="module")
def warped():
    """(JAX tracer, port tracer, boundary masks) after 3 steps and two
    temporal warps with the same jitter, a step after each."""
    js = jax_default_scene()
    jp = JaxPathTracer(js, W, H, shadows=False, antialias=False)
    pp = PathTracer(port_scene_from_jax(js), W, H, shadows=False, antialias=False, device="cpu")
    for _ in range(3):
        jp.step()
        pp.step()
    pp._warp_jitter = lambda: _jax_jitter(jp, pp._warp_no, W * H)
    states = []
    for move in ([0.08, 0.0, 0.0], [0.05, 0.05, 0.02]):
        jc = jp.scene.camera
        jm = JaxCamera(position=jc.position + jnp.asarray(move), direction=jc.direction,
                       up=jc.up, fov=jc.fov)
        old_cam, old_fs = pp.scene.camera, pp.tables.render.fov_scale
        jp.set_camera(jm, temporal=True)
        pp.set_camera(_moved(old_cam, move), temporal=True)
        boundary = _boundary_pixels(pp, old_cam, old_fs, _jax_jitter(jp, pp._warp_no, W * H))
        states.append((np.array(jp.accum), np.array(jp._count_base), pp.accum.numpy().copy(),
                       pp._count_base.numpy().copy(), boundary))
        jp.step()
        pp.step()
    return jp, pp, states


@pytest.mark.parametrize("warp", [0, 1])
def test_warp_matches_jax(warped, warp):
    ja, jn, pa, pn, boundary = warped[2][warp]
    assert boundary.mean() <= MAX_BOUNDARY_SHARE
    assert not ((pn != jn) & ~boundary).any(), f"{((pn != jn) & ~boundary).sum()} pixels"
    ok = (np.abs(pa - ja) / np.maximum(np.abs(ja), 1.0)).max(axis=1) <= TOL
    assert ok.mean() >= MIN_SHARE, ok.mean()
    assert (jn > 0).mean() > 0.5


def test_image_after_the_warps_matches_jax(warped):
    jp, pp, _ = warped
    assert pp._warp_no == 2 and pp.samples == jp.samples == 1
    diff = np.abs(pp.image() - jp.image()).max(axis=2)
    assert (diff <= TOL).mean() >= MIN_SHARE


# ---- the warp's own contract (tests/test_temporal.py) on the port ----

def test_identity_warp_preserves_image():
    pt = _pt(spp=3)
    before = pt.image()
    pt.set_camera(pt.scene.camera, temporal=True)
    assert pt.samples == 0 and pt._count_base is not None
    n0 = pt._count_base.numpy()
    assert (n0 > 0).mean() > 0.98 and n0.max() == pytest.approx(3.0)
    assert (np.abs(pt.image() - before).max(axis=-1) > 2e-5).mean() < 0.01


def test_rotation_disoccludes_and_translation_transports():
    pt = _pt(spp=4)
    pt.set_camera(_moved(pt.scene.camera, [0.08, 0.0, 0.0]), temporal=True)
    assert (pt._count_base > 0).float().mean() > 0.5 and np.isfinite(pt.image()).all()
    pt = _pt(spp=4)
    cam = pt.scene.camera
    c, s = np.cos(0.5), np.sin(0.5)
    d = cam.direction.numpy()
    nd = torch.tensor([c * d[0] + s * d[2], d[1], -s * d[0] + c * d[2]], dtype=torch.float32)
    pt.set_camera(_moved(cam, [0.0, 0.0, 0.0], direction=nd), temporal=True)
    n0 = pt._count_base.numpy()
    assert (n0 == 0).any() and (n0 > 0).any()


def test_clamp_bounds_history():
    pt = _pt(spp=12)
    pt.temporal_clamp = 4.0
    pt.set_camera(pt.scene.camera, temporal=True)
    assert pt._count_base.max().item() == pytest.approx(4.0)


def test_blend_arithmetic_after_new_samples():
    """image() is (history_mean * n0 + new_sum) / (n0 + k)."""
    pt = _pt(spp=2)
    pt.set_camera(pt.scene.camera, temporal=True)
    n0 = pt._count_base.numpy().copy()
    pt.step()
    pt.step()
    want = pt.accum.numpy() / np.maximum(n0 + 2, 1.0)[:, None]
    np.testing.assert_allclose(pt.image()[pt._py_host, pt._px_host], want, rtol=1e-5)
    np.testing.assert_allclose(pt.image_device().numpy(), pt.image(), rtol=1e-6, atol=0)
    assert np.isfinite(pt.denoised_image(iterations=2)).all()


def test_reset_and_nontemporal_set_camera_clear_history():
    pt = _pt(spp=2)
    pt.set_camera(pt.scene.camera, temporal=True)
    pt.gbuffer()
    assert pt._count_base is not None and pt._gbuf is not None
    pt.reset()
    assert pt._count_base is None and pt._gbuf is None and pt._gbuf_tile is None
    assert np.abs(pt.image()).max() == 0.0
    pt = _pt(spp=2)
    pt.set_camera(pt.scene.camera)
    assert pt.samples == 0 and pt._count_base is None


def test_cached_gbuffer_warp_matches_retrace():
    """The second warp takes the old depth from the first warp's tile-order
    G-buffer, from the row-major planes of gbuffer(), or traces it: the
    three are bit-equal."""
    def two_warps(mode):
        pt = _pt(spp=3)
        cam = pt.scene.camera
        pt.set_camera(_moved(cam, [0.05, 0.0, 0.0]), temporal=True)
        assert pt._gbuf_tile is not None
        pt.step()
        if mode == "rowmajor":
            pt.gbuffer()
            pt._gbuf_tile = None
        elif mode == "retrace":
            pt._gbuf = pt._gbuf_tile = None
        pt.set_camera(_moved(cam, [0.05, 0.05, 0.0]), temporal=True)
        return pt.accum.numpy(), pt._count_base.numpy()

    a_tile, n_tile = two_warps("tile")
    for mode in ("rowmajor", "retrace"):
        a, n = two_warps(mode)
        np.testing.assert_array_equal(n, n_tile)
        np.testing.assert_array_equal(a, a_tile)


def test_gbuffer_and_denoise_after_a_warp_match_a_fresh_trace():
    pt = _pt(spp=2)
    pt.set_camera(_moved(pt.scene.camera, [0.03, 0.0, 0.0]), temporal=True)
    pt.step()
    assert pt._gbuf_tile is not None and pt._gbuf is None
    cached = [x.clone() for x in pt.gbuffer()]
    lazy = pt.denoised_frame(iterations=2)
    pt._gbuf = pt._gbuf_tile = None
    for c, f in zip(cached, pt.gbuffer()):
        assert torch.equal(c, f)
    assert torch.equal(lazy, pt.denoised_frame(iterations=2))


def test_warp_jitter_is_a_seeded_stream():
    from gpu_raytracer_tpu_torch.engine.pathtracer import warp_jitter

    a = warp_jitter(0, 1, 4096, torch.device("cpu"))
    assert a.shape == (4096, 2) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, warp_jitter(0, 1, 4096, torch.device("cpu")))
    assert not torch.equal(a, warp_jitter(0, 2, 4096, torch.device("cpu")))
    assert not torch.equal(a, warp_jitter(1, 1, 4096, torch.device("cpu")))
