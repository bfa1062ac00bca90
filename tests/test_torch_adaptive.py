"""Adaptive path tracing (engine/adaptive.py) against the JAX package
(mirrors tests/test_adaptive.py).

The adaptive pool draws from the independent stream (threefry in JAX,
torch.Generator here), so the images agree only statistically, at JAX's
own bound (means within 20%). The tile selection is held exactly: the
same accumulators in give the same tiles out, including built ties, where
both take the lower tile index first. It is read from the counts one step
adds. Checkpoints carry JAX's keys and load in either package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu import build_default_scene as jax_default_scene
from gpu_raytracer_tpu.engine.adaptive import AdaptivePathTracer as JaxAdaptive
from gpu_raytracer_tpu.engine.pathtracer import PathTracer as JaxPathTracer
from gpu_raytracer_tpu_torch.engine.adaptive import TILE_PX, AdaptivePathTracer, select_tiles

SIZE = 128   # T = 4 tiles of 64x64


@pytest.fixture(scope="module")
def scenes():
    js = jax_default_scene()
    return js, port_scene_from_jax(js)


def _make(scene, K=2, **kw):
    kw.setdefault("shadows", False)
    return AdaptivePathTracer(scene, SIZE, SIZE, tiles_per_step=K, device="cpu", **kw)


def _tiles_added(before, after, T):
    return (np.asarray(after) - np.asarray(before)).reshape(T, TILE_PX)[:, 0]


def _accumulators(seed, T, tie=False):
    """Seeded accumulators: every tile seeded (n >= 2) but one, or with
    `tie` tiles 1 and 3 (and 0 and 2) holding identical pixels."""
    rng = np.random.default_rng(seed)
    C = T * TILE_PX
    counts = rng.integers(2, 9, C).astype(np.int32).reshape(T, TILE_PX)
    counts[:, :] = counts[:, :1]
    accum = (rng.exponential(0.3, (C, 3)) * counts.reshape(-1, 1)).astype(np.float32)
    lum = accum.mean(axis=1)
    accum_sq = (lum ** 2 / counts.reshape(-1) * rng.uniform(1.0, 3.0, C)).astype(np.float32)
    if tie:
        for a, b in ((1, 3), (0, 2)):
            sl = lambda t: slice(t * TILE_PX, (t + 1) * TILE_PX)
            accum[sl(b)], accum_sq[sl(b)], counts[b] = accum[sl(a)], accum_sq[sl(a)], counts[a]
    else:
        counts[T - 1] = 1
    return accum, accum_sq, counts.reshape(-1)


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("tie", [False, True])
def test_tile_selection_matches_jax(scenes, K, tie):
    """One step of each package from the same accumulators, after the
    warm-up: the tiles refined are the same, tile for tile."""
    js, ps = scenes
    jp = JaxAdaptive(js, SIZE, SIZE, shadows=False, tiles_per_step=K)
    pp = _make(ps, K=K)
    accum, accum_sq, counts = _accumulators(K + 10 * tie, jp.T, tie=tie)
    g = jp.adaptive_from + 1
    jp.accum, jp.accum_sq = jnp.asarray(accum), jnp.asarray(accum_sq)
    jp.counts = jnp.asarray(counts)
    jp._steps = pp._steps = g
    pp.accum, pp.accum_sq = torch.from_numpy(accum.copy()), torch.from_numpy(accum_sq.copy())
    pp.counts = torch.from_numpy(counts.copy())
    sel = select_tiles(pp.accum, pp.accum_sq, pp.counts, g, pp.K, pp.T, pp.adaptive_from)
    jp.step()
    pp.step()
    want = _tiles_added(counts, jp.counts, jp.T)
    np.testing.assert_array_equal(_tiles_added(counts, pp.counts, pp.T), want)
    np.testing.assert_array_equal(np.bincount(sel.numpy(), minlength=pp.T), want)
    if tie and K == 2:   # K_RR = 1 sweep tile, then the top score: a built tie
        assert sel.tolist()[1] in (0, 1)


def test_requires_tile_multiple(scenes):
    with pytest.raises(ValueError):
        AdaptivePathTracer(scenes[1], 100, 64, device="cpu")


def test_warmup_covers_every_tile(scenes):
    pt = _make(scenes[1], K=2)
    assert pt.T == 4 and pt.adaptive_from == 4
    pt.step()
    pt.step()
    assert (pt.counts == 1).all() and pt.samples == pytest.approx(1.0)
    pt.step()
    pt.step()
    assert (pt.counts == 2).all()


def test_adaptive_concentrates_samples_and_keeps_the_per_pixel_mean(scenes):
    pt = _make(scenes[1], K=1)
    for _ in range(pt.adaptive_from + 8):
        pt.step()
    counts = pt.counts.numpy().reshape(pt.T, TILE_PX)
    per_tile = counts[:, 0]
    assert (counts >= 1).all() and (counts == counts[:, :1]).all()
    assert per_tile.max() >= per_tile.min() + 4
    want = pt.accum.numpy() / np.maximum(pt.counts.numpy(), 1)[:, None]
    np.testing.assert_allclose(pt.image()[pt._py_host, pt._px_host], want, rtol=1e-6)
    np.testing.assert_allclose(pt.image_device().numpy(), pt.image(), rtol=1e-6)
    img = pt.denoised_image(iterations=2)
    assert img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()


def test_statistical_agreement_with_the_jax_uniform_tracer(scenes):
    """The adaptive estimator is unbiased: its mean brightness agrees with
    the JAX package's uniform tracer (JAX's own bound)."""
    js, ps = scenes
    a = _make(ps, K=4, seed=2)   # K == T: every step uniform
    for _ in range(8):
        a.step()
    u = JaxPathTracer(js, SIZE, SIZE, shadows=False, seed=3)
    for _ in range(8):
        u.step()
    ma, mu = a.image().mean(), u.image().mean()
    assert abs(ma - mu) / max(mu, 1e-6) < 0.2


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_load_in_either_package(scenes, tmp_path, direction):
    js, ps = scenes
    path = str(tmp_path / "ada.npz")
    if direction == "jax_to_port":
        src = JaxAdaptive(js, SIZE, SIZE, shadows=False, tiles_per_step=2, seed=1)
        dst = _make(ps, K=2, seed=1)
    else:
        src = _make(ps, K=2, seed=1)
        dst = JaxAdaptive(js, SIZE, SIZE, shadows=False, tiles_per_step=2, seed=1)
    for _ in range(4):
        src.step()
    src.save_checkpoint(path)
    dst.load_checkpoint(path)
    assert dst._steps == src._steps and dst.samples == src.samples
    np.testing.assert_array_equal(np.asarray(dst.counts), np.asarray(src.counts))
    np.testing.assert_allclose(dst.image(), src.image())
    before = np.asarray(dst.counts).sum()
    dst.step()
    assert np.asarray(dst.counts).sum() > before


def test_temporal_warp_folds_history_into_the_counts(scenes):
    pt = _make(scenes[1], K=2)
    for _ in range(pt.adaptive_from):
        pt.step()
    pt.set_camera(pt.scene.camera, temporal=True)
    counts = pt.counts.clone()
    assert pt._count_base is None and counts.max().item() == 2
    assert np.isfinite(pt.image()).all()
    pt.step()
    assert pt.counts.sum() > counts.sum()
