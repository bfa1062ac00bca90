"""Interleaved sampling (PathTracer.step_interleaved) against the JAX
package (mirrors tests/test_interleave.py; the Viewer is not ported yet).

The coset partition and its rotation are held exactly; with the QMC
sampler a coset lane's identity is JAX's (sample 0x7000 + step, pixel id
phase * C/m + lane), so the interleaved image is held to JAX's at the path
tracer tests' bar: within 1e-5 on at least 99% of the pixels."""

import numpy as np
import pytest
import torch

from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu import build_default_scene as jax_default_scene
from gpu_raytracer_tpu.engine.pathtracer import PathTracer as JaxPathTracer
from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
from gpu_raytracer_tpu_torch.models.scene import build_default_scene

W, H = 64, 64
TOL = 1e-5
MIN_SHARE = 0.99


@pytest.fixture(scope="module")
def scene():
    return build_default_scene()


def test_cosets_and_rotation_match_jax(scene):
    jp = JaxPathTracer(jax_default_scene(), W, H, shadows=False)
    pt = PathTracer(scene, W, H, shadows=False, device="cpu")
    for m in (2, 4, 8):
        assert pt.interleave_ok(m) == jp.interleave_ok(m)
        for (idx, px, py), (jidx, jpx, jpy) in zip(pt._cosets(m), jp._cosets(m), strict=True):
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
            np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))
    assert not pt.interleave_ok(1) and not pt.interleave_ok(3)


@pytest.fixture(scope="module")
def interleaved():
    """(JAX tracer, port tracer, per-call (phase, il_step) of both): one full
    step, then interleaved steps m = 4, 4, 4, 4, 8, 2."""
    js = jax_default_scene()
    jp = JaxPathTracer(js, W, H, shadows=False)
    pp = PathTracer(port_scene_from_jax(js), W, H, shadows=False, device="cpu")
    jp.step()
    pp.step()
    phases = []
    for m in (4, 4, 4, 4, 8, 2):
        jp.step_interleaved(m)
        pp.step_interleaved(m)
        phases.append(((pp._il_phase, pp._il_step, pp._last_seed),
                       (jp._il_phase, jp._il_step, jp._last_seed)))
    return jp, pp, phases


def test_rotation_and_sample_index_match_jax(interleaved):
    _, _, phases = interleaved
    for got, want in phases:
        assert got == want


def test_interleaved_image_matches_jax(interleaved):
    jp, pp, _ = interleaved
    np.testing.assert_array_equal(pp._count_base.numpy(), np.asarray(jp._count_base))
    assert pp.samples == jp.samples == 0
    diff = np.abs(pp.image() - jp.image()).max(axis=2)
    assert (diff <= TOL).mean() >= MIN_SHARE, (diff <= TOL).mean()
    counts = pp.counters().rays_per_bounce[0]
    assert counts == jp.counters().rays_per_bounce[0] == W * H // 2


# ---- bookkeeping and quality (tests/test_interleave.py) on the port ----

def test_full_rotation_covers_every_pixel_once(scene):
    pt = PathTracer(scene, W, H, shadows=False, device="cpu")
    for _ in range(4):
        pt.step_interleaved(4)
    assert pt.samples == 0
    np.testing.assert_array_equal(pt._count_base.numpy(), np.ones(W * H, np.float32))
    img = pt.image()
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 1e-3


def test_cosets_partition_the_frame(scene):
    pt = PathTracer(scene, W, H, shadows=False, device="cpu")
    for m in (2, 4, 8):
        sets = pt._cosets(m)
        rows = torch.cat([idx for idx, _, _ in sets]).numpy()
        assert np.array_equal(np.sort(rows), np.arange(W * H))
        for idx, px, py in sets:
            i = idx.numpy()
            assert (np.diff(i) > 0).all()
            np.testing.assert_array_equal(px.numpy(), pt._px_host[i])
            np.testing.assert_array_equal(py.numpy(), pt._py_host[i])


def test_mixed_full_and_partial_bookkeeping(scene):
    pt = PathTracer(scene, W, H, shadows=False, device="cpu")
    pt.step()
    pt.step_interleaved(4)
    counts = pt._count_base.numpy()
    assert pt.samples == 0
    assert (np.unique(counts) == [1.0, 2.0]).all() and (counts == 2.0).sum() == W * H // 4
    assert np.isfinite(pt.image()).all()


def test_interleaved_mean_matches_full_mean(scene):
    """A rotation of interleaved steps and a full step estimate the same
    image: their difference is sample noise."""
    a = PathTracer(scene, W, H, shadows=False, seed=0, device="cpu")
    b = PathTracer(scene, W, H, shadows=False, seed=0, device="cpu")
    for _ in range(4):
        a.step()
    for _ in range(16):
        b.step_interleaved(4)
    assert b._count_base.min().item() == 4
    ia, ib = a.image(), b.image()
    assert np.mean((ia - ib) ** 2) / (np.mean(ia ** 2) + 1e-9) < 0.5


def test_interleave_falls_back_when_frame_does_not_divide(scene):
    pt = PathTracer(scene, 66, 33, shadows=False, device="cpu")
    assert not pt.interleave_ok(4)
    pt.step_interleaved(4)
    assert pt.samples == 1 and pt._count_base is None
    jp = JaxPathTracer(jax_default_scene(), 66, 33, shadows=False)
    jp.step_interleaved(4)
    assert jp.samples == 1 and jp._count_base is None
    diff = np.abs(pt.image() - jp.image()).max(axis=2)
    assert (diff <= TOL).mean() >= MIN_SHARE
