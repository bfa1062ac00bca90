"""The port's spatial-split (SBVH) and NumPy binned-SAH builders against the
JAX package's, on the CPU.

`build_bvh_spatial` bit for bit on the JAX package's own SBVH geometries
(test_bvh.py: long thin triangles beside small ones, every reference
straddling the plane, triangles flat on a split plane), the SBVH courtyard
`Scene` bit for bit (at width 4 and 8), its frame against JAX's
`render_chunk`, and `build_bvh(use_native=False)` bit for bit; the native
builder stays the default and never falls back to NumPy.

Frame tolerance: max |diff| <= 1e-5 per channel outside counted
rounding-sensitive pixels (tests/test_torch_render.py), at most 1% of a
frame."""

import numpy as np
import pytest
import torch

from torch_bridge import (assert_arrays_equal, f16_attenuation_flips, jax_scene_arrays,
                          port_scene_from_jax, rounding_sensitive_pixels, scene_to_arrays)

from gpu_raytracer_tpu.config import RaytracerConfig as JaxConfig
from gpu_raytracer_tpu.engine.renderer import render_chunk as jax_render_chunk
from gpu_raytracer_tpu.models.bvh import build_bvh as jax_build_bvh
from gpu_raytracer_tpu.models.bvh import build_bvh_spatial as jax_build_bvh_spatial
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.ops.render import render_chunk
from gpu_raytracer_tpu_torch.models import bvh_native
from gpu_raytracer_tpu_torch.models.bvh import (BvhBuildResult, build_bvh, build_bvh_spatial,
                                                scene_tree, validate_bvh)
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.trace import trace
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

TOL = 1e-5
MAX_COUNTED_SHARE = 0.01
FIELDS = ("node_min", "node_max", "left", "right", "tri_start", "tri_count", "tri_order")


def _long_and_small():
    """test_bvh.py::test_spatial_splits_build_and_parity: long thin diagonal
    triangles spanning many cells beside a cluster of small ones."""
    rng = np.random.default_rng(3)
    n_long, n_small = 60, 300
    v0 = rng.uniform(-10, 10, (n_long, 3)).astype(np.float32)
    d1 = rng.normal(size=(n_long, 3)).astype(np.float32)
    d1 = d1 / np.linalg.norm(d1, axis=1, keepdims=True) * 15.0
    d2 = rng.normal(size=(n_long, 3)).astype(np.float32) * 0.1
    sm0 = rng.uniform(-10, 10, (n_small, 3)).astype(np.float32)
    verts = np.concatenate([
        v0, v0 + d1, v0 + d2,
        sm0, sm0 + rng.normal(size=(n_small, 3)).astype(np.float32) * 0.3,
        sm0 + rng.normal(size=(n_small, 3)).astype(np.float32) * 0.3]).astype(np.float32)
    il = np.stack([np.arange(n_long), np.arange(n_long) + n_long,
                   np.arange(n_long) + 2 * n_long], 1)
    base = 3 * n_long
    ismall = np.stack([base + np.arange(n_small), base + np.arange(n_small) + n_small,
                       base + np.arange(n_small) + 2 * n_small], 1)
    return verts, np.concatenate([il, ismall]).astype(np.uint32), 8


def _all_straddle():
    """test_bvh.py::test_spatial_splits_all_straddle_degenerate_covers: 12
    triangles of one centroid spanning x in [0, 16]."""
    verts = [[[0.0, 0.01 * i, 0.0], [16.0, 0.01 * i + 0.5, 0.0], [8.0, 0.01 * i + 1.0, 1.0]]
             for i in range(12)]
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    return v, np.arange(v.shape[0], dtype=np.uint32).reshape(-1, 3), 4


def _flat_on_plane():
    """test_bvh.py::test_spatial_splits_flat_ref_on_plane_not_duplicated_in_place:
    x-flat triangles exactly on the bin-edge planes of long ones."""
    tris = [[[0.0, 0.3 * i, 0.0], [16.0, 0.3 * i + 0.4, 0.2], [8.0, 0.3 * i + 0.8, 0.6]]
            for i in range(24)]
    tris += [[[2.0 * (i + 1), 0.1 * i, 0.0], [2.0 * (i + 1), 1.0 + 0.1 * i, 0.0],
              [2.0 * (i + 1), 0.5, 1.0]] for i in range(8)]
    v = np.asarray(tris, np.float32).reshape(-1, 3)
    return v, np.arange(v.shape[0], dtype=np.uint32).reshape(-1, 3), 4


GEOMETRIES = {"long_and_small": _long_and_small, "all_straddle": _all_straddle,
              "flat_on_plane": _flat_on_plane}


def _assert_builds_equal(got: BvhBuildResult, want) -> None:
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f
    assert got.max_depth == want.max_depth and got.leaf_align == want.leaf_align


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_spatial_build_is_bit_equal_to_jax(name):
    verts, idx, leaf = GEOMETRIES[name]()
    got = build_bvh_spatial(verts, idx, leaf_size=leaf)
    _assert_builds_equal(got, jax_build_bvh_spatial(verts, idx, leaf_size=leaf))
    validate_bvh(got, idx.shape[0], allow_refs=True)
    refs = got.tri_order[got.tri_order >= 0]
    assert set(refs.tolist()) == set(range(idx.shape[0]))
    if name == "long_and_small":
        assert refs.shape[0] > idx.shape[0]   # references were duplicated


def test_spatial_build_of_no_triangles():
    got = build_bvh_spatial(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32))
    want = jax_build_bvh_spatial(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32))
    _assert_builds_equal(got, want)


@pytest.mark.parametrize("seed, leaf", [(4, 8), (7, 4)])
def test_numpy_sah_build_is_bit_equal_to_jax(seed, leaf):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    idx = rng.integers(0, 3000, (2000, 3)).astype(np.uint32)
    got = build_bvh(verts, idx, leaf_size=leaf, use_native=False)
    _assert_builds_equal(got, jax_build_bvh(verts, idx, leaf_size=leaf, use_native=False))
    validate_bvh(got, idx.shape[0])
    assert int(got.tri_count.max()) <= leaf


def test_native_builder_is_the_default_and_never_falls_back(monkeypatch):
    """build_bvh builds natively unless the caller asks for NumPy; a native
    library that does not load raises, it is not replaced by the NumPy build."""
    rng = np.random.default_rng(1)
    verts = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    idx = rng.integers(0, 300, (200, 3)).astype(np.uint32)
    calls = []
    native = bvh_native.build_bvh_native
    monkeypatch.setattr(bvh_native, "build_bvh_native",
                        lambda *a: (calls.append(a), native(*a))[1])
    build_bvh(verts, idx, leaf_size=8)
    assert len(calls) == 1
    build_bvh(verts, idx, leaf_size=8, use_native=False)
    assert len(calls) == 1

    def broken():
        raise RuntimeError("no native BVH builder")

    monkeypatch.setattr(bvh_native, "build_bvh_native", native)
    monkeypatch.setattr(bvh_native, "load_builder", broken)
    with pytest.raises(RuntimeError, match="no native BVH builder"):
        build_bvh(verts, idx, leaf_size=8)


SBVH = {"sbvh": (JaxConfig(bvh_spatial_splits=True), RaytracerConfig(bvh_spatial_splits=True)),
        "sbvh_w8": (JaxConfig(bvh_spatial_splits=True, bvh_width=8),
                    RaytracerConfig(bvh_spatial_splits=True, bvh_width=8))}


@pytest.fixture(scope="module")
def sbvh_scenes():
    return {name: (jax_courtyard(3000, seed=2, config=jc), make_courtyard_scene(
        3000, seed=2, config=pc)) for name, (jc, pc) in SBVH.items()}


@pytest.mark.parametrize("name", sorted(SBVH))
def test_sbvh_courtyard_scene_is_bit_equal_to_jax(sbvh_scenes, name):
    js, ps = sbvh_scenes[name]
    a, b = jax_scene_arrays(js), scene_to_arrays(ps)
    assert_arrays_equal(a, b)
    assert_arrays_equal(scene_to_arrays(port_scene_from_jax(js)), b)
    assert ps.bvh.q_child.shape[1] == (8 if name == "sbvh_w8" else 4)
    tree = scene_tree(ps)
    validate_bvh(tree, ps.num_triangles, allow_refs=True)
    src = ps.tri_src[ps.tri_src >= 0]
    assert src.unique().shape[0] == ps.num_triangles   # every triangle, some twice
    assert src.shape[0] >= ps.num_triangles


@pytest.mark.parametrize("shadows", [False, True])
def test_sbvh_frame_matches_jax_render_chunk(sbvh_scenes, shadows):
    js, ps = sbvh_scenes["sbvh"]
    W, H = 64, 48
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    px, py = px.reshape(-1).contiguous(), py.reshape(-1).contiguous()
    import jax.numpy as jnp

    want = np.asarray(jax_render_chunk(js, jnp.asarray(px.numpy()), jnp.asarray(py.numpy()),
                                       W, H, shadows=shadows)).reshape(H, W, 3)
    got = render_chunk(ps, px, py, W, H, shadows=shadows).numpy().reshape(H, W, 3)
    assert np.isfinite(got).all() and got.max() > 0.05
    o, d = generate_rays(ps.camera, W, H, px, py)
    counted = (f16_attenuation_flips(ps, trace(ps, o, d)).reshape(H, W)
               | rounding_sensitive_pixels(ps, W, H, shadows=shadows))
    assert counted.sum() <= MAX_COUNTED_SHARE * counted.size, counted.sum()
    diff = np.abs(got - want).max(axis=-1)
    assert diff[~counted].max() <= TOL, f"{diff[~counted].max():.3g} off {counted.sum()} counted"
