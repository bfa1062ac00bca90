"""The port's on-device LBVH build and scene refit (ops/lbvh.py,
models/scene.py::refit_scene) against the JAX package's, on the CPU.

Integer arrays (codes, links, leaf ranges, orders, quad children) must be
equal and boxes and triangle tables the same values: both sides compute
them with min / max and the same subtractions. Frames of refit and rebuilt
scenes are held to the JAX package's XLA renderer at 1e-5, outside counted
rounding-sensitive pixels (tests/torch_bridge.py; at most 1% of a frame):
both plain walks take the same binary tree in the same order, so an exact-t
tie goes the same way on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import (assert_arrays_equal, f16_attenuation_flips, jax_scene_arrays,
                          port_scene_from_jax, rounding_sensitive_pixels, scene_to_arrays)

from gpu_raytracer_tpu.engine.renderer import Renderer as JaxRenderer
from gpu_raytracer_tpu.models.scene import memory_stats as jax_memory_stats
from gpu_raytracer_tpu.models.scene import refit_scene as jax_refit_scene
from gpu_raytracer_tpu.ops import lbvh as jlbvh
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.engine.renderer import Renderer
from gpu_raytracer_tpu_torch.models.bvh import BvhBuildResult, scene_tree, validate_bvh
from gpu_raytracer_tpu_torch.models.scene import (LBVH_DEPTH, memory_stats, print_memory_usage,
                                                  refit_scene)
from gpu_raytracer_tpu_torch.ops import lbvh
from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
from gpu_raytracer_tpu_torch.ops.cuda import traverse as cuda_traverse
from gpu_raytracer_tpu_torch.ops.cuda.traverse import (LBVH_WIDE_DEPTH, STACK_SIZES,
                                                       pack_trace_tables, refit_trace_tables,
                                                       wide_depth)
from gpu_raytracer_tpu_torch.ops.texture import uv_density_code
from gpu_raytracer_tpu_torch.ops.trace import trace

TOL = 1e-5
MAX_COUNTED_SHARE = 0.01
W, H = 64, 48


def _np(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in xs]


def _equal(a, b):
    return a.shape == b.shape and np.array_equal(a, b)


def test_nlz32_matches_jax():
    vals = np.array([0, 1, 2, 3, 0x80000000, 0x7FFFFFFF, 0xFFFFFFFF, 1 << 20], np.uint32)
    got = lbvh._nlz32(torch.from_numpy(vals.astype(np.int64))).numpy()
    want = np.asarray(jlbvh._nlz32(jnp.asarray(vals)))
    assert got.tolist() == want.tolist() == [32, 31, 30, 30, 0, 1, 0, 11]


def test_expand_bits_and_morton_codes_match_jax():
    v = np.arange(1024, dtype=np.uint32)
    assert _equal(lbvh.expand_bits_10(torch.from_numpy(v.astype(np.int64))).numpy(),
                  np.asarray(jlbvh.expand_bits_10(jnp.asarray(v))).astype(np.int64))
    rng = np.random.default_rng(3)
    c = rng.uniform(-5, 5, (20000, 3)).astype(np.float32)
    c[:100] = c[100]                      # equal codes
    lo, hi = c.min(0) + np.float32(0.5), c.max(0)   # some centroids clip to 0
    got = lbvh.morton_codes(torch.from_numpy(c), torch.from_numpy(lo), torch.from_numpy(hi))
    want = np.asarray(jlbvh.morton_codes(jnp.asarray(c), jnp.asarray(lo), jnp.asarray(hi)))
    assert _equal(got.numpy(), want.astype(np.int64))


def _boxes(T, seed, grid=False):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (T, 3)).astype(np.float32)
    if grid:   # centres on a coarse grid: runs of equal Morton codes
        base = np.round(base / 4.0).astype(np.float32) * np.float32(4.0)
    tmin = base - rng.uniform(0, 0.5, (T, 3)).astype(np.float32)
    tmax = base + rng.uniform(0, 0.5, (T, 3)).astype(np.float32)
    return tmin, tmax


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("T,grid", [(2, False), (9, False), (64, False), (3001, True)])
def test_lbvh_arrays_and_collapse_match_jax(T, grid, grouped):
    tmin, tmax = _boxes(T, T, grid)
    jfn = jlbvh.build_lbvh_grouped_arrays if grouped else jlbvh.build_lbvh_arrays
    pfn = lbvh.build_lbvh_grouped_arrays if grouped else lbvh.build_lbvh_arrays
    want = _np(jfn(jnp.asarray(tmin), jnp.asarray(tmax)))
    got = _np(pfn(torch.from_numpy(tmin), torch.from_numpy(tmax)))
    names = ("node_min", "node_max", "left", "right", "tri_start", "tri_count", "hit", "miss",
             "order")
    assert [n for n, a, b in zip(names, got, want) if not _equal(a, b.astype(a.dtype))] == []
    assert all(a.dtype == np.int32 for a in got[2:])
    # the binary tree is valid: every triangle once, children inside parents
    order = got[8]
    G = got[2].shape[0] // 2 + 1
    slots = np.full(G * (8 if grouped else 1), -1, np.int64)
    slots[:T] = order
    validate_bvh(BvhBuildResult(got[0], got[1], got[2], got[3], got[4], got[5], slots, 0), T)
    if got[2].shape[0] > 1:
        qw = _np(jlbvh.collapse4_device(*[jnp.asarray(x) for x in want[:6]]))
        qg = _np(lbvh.collapse4_device(*[torch.from_numpy(x) for x in got[:6]]))
        assert [i for i, (a, b) in enumerate(zip(qg, qw)) if not _equal(a, b)] == []


@pytest.mark.parametrize("group", [1, 8])
def test_lbvh_from_mesh_matches_jax(group):
    rng = np.random.default_rng(5)
    n = 301
    v0 = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    verts = np.concatenate([v0, v0 + rng.normal(size=(n, 3)).astype(np.float32) * 0.5,
                            v0 + rng.normal(size=(n, 3)).astype(np.float32) * 0.5])
    idx = np.arange(3 * n, dtype=np.uint32).reshape(3, n).T.copy()
    mat = (np.arange(n) % 3).astype(np.uint32)
    jb, *jt = jlbvh.lbvh_from_mesh_device(jnp.asarray(verts), jnp.asarray(idx),
                                          jnp.asarray(mat), group=group)
    pb, *pt = lbvh.lbvh_from_mesh_device(torch.from_numpy(verts),
                                         torch.from_numpy(idx.astype(np.int64)),
                                         torch.from_numpy(mat.astype(np.int64)), group=group)
    for a, b in zip(_np(pt), _np(jt)):
        assert _equal(a, b.astype(a.dtype))
    for f in ("node_min", "node_max", "left", "right", "tri_start", "tri_count", "hit_link",
              "miss_link"):
        assert _equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)))
    assert (pb.leaf_align, pb.max_leaf) == (group, group)


@pytest.fixture(scope="module")
def courtyards():
    out = {}
    for textured in (False, True):
        js = jax_courtyard(2000, seed=0, textured=textured)
        out[textured] = (js, port_scene_from_jax(js))
    return out


def _moved(scene, scale=1.0):
    """The mesh's vertices scaled about the origin, then shifted: a move
    that changes every triangle's size (and so its uv density)."""
    v = np.asarray(scene.mesh.vertices, np.float32)
    return (v * np.float32(scale) + np.float32([0.1, 0.2, -0.3])).astype(np.float32)


@pytest.mark.parametrize("rebuild", [False, True])
@pytest.mark.parametrize("textured", [False, True])
def test_refit_scene_matches_jax(courtyards, textured, rebuild):
    js, ps = courtyards[textured]
    moved = _moved(js, 1.3)
    want = jax_refit_scene(js, jnp.asarray(moved), rebuild=rebuild)
    got = refit_scene(ps, moved, rebuild=rebuild)
    # every field, the tree and the triangle tables (v0, e1, e2, uv,
    # tri_src) bit for bit; tri_den against the code of JAX's triangles
    assert_arrays_equal(scene_to_arrays(got), jax_scene_arrays(want))
    assert torch.equal(got.tri_den, port_scene_from_jax(want).tri_den)
    assert got.bvh.depth == (LBVH_DEPTH if rebuild else ps.bvh.depth)
    if not rebuild:   # the tree's tensors are kept, not copied
        assert got.bvh.left is ps.bvh.left and got.bvh.q_child is ps.bvh.q_child
    else:
        T = ps.num_triangles
        assert got.tri_v0.shape[0] == 8 * -(-T // 8)
        assert got.bvh.q_child.shape[0] == got.bvh.num_nodes // 2   # Q = I
    validate_bvh(scene_tree(got), got.num_triangles)


def test_refit_recomputes_the_uv_density_after_a_scaling(courtyards):
    """A non-rigid move changes each triangle's texel density: the refit
    scene's tri_den is the code of its own triangles, not the old one."""
    _, ps = courtyards[True]
    for rebuild in (False, True):
        got = refit_scene(ps, _moved(ps, 2.0), rebuild=rebuild)
        assert torch.equal(got.tri_den, uv_density_code(got.tri_e1, got.tri_e2, got.tri_uv))
        if not rebuild:   # same slots: every textured triangle's code moved
            real = (got.tri_src >= 0) & (ps.tri_den > 0)
            assert real.sum() > 1000 and (got.tri_den != ps.tri_den)[real].all()


def _counted(ps, shadows):
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(ps.camera, W, H, px.reshape(-1), py.reshape(-1))
    flips = f16_attenuation_flips(ps, trace(ps, o, d)).reshape(H, W)
    return flips | rounding_sensitive_pixels(ps, W, H, shadows=shadows)


@pytest.mark.parametrize("rebuild", [False, True])
def test_frames_of_refit_scenes_match_jax(courtyards, rebuild):
    js, ps = courtyards[False]
    moved = _moved(js, 1.1)
    jr = jax_refit_scene(js, jnp.asarray(moved), rebuild=rebuild)
    pr = refit_scene(ps, moved, rebuild=rebuild)
    want = JaxRenderer(jr, W, H, shadows=True).render()
    got = Renderer(pr, W, H, shadows=True, device="cpu").render()
    assert np.isfinite(got).all() and got.max() > 0.05
    counted = _counted(pr, True)
    assert counted.sum() <= MAX_COUNTED_SHARE * counted.size, counted.sum()
    diff = np.abs(got - want).max(axis=-1)
    assert diff[~counted].max() <= TOL, f"{diff[~counted].max():.3g} off {counted.sum()} counted"
    # and the refit frame is the moved geometry's: not the old frame
    assert not np.array_equal(got, Renderer(ps, W, H, shadows=True, device="cpu").render())


def test_rebuilt_tree_fits_the_declared_stack_without_a_host_read(monkeypatch):
    """A rebuilt tree's tables take the 128-entry stack from the declared
    bound (LBVH_WIDE_DEPTH) and never read the tree back; on a mesh of many
    equal Morton codes its real BVH4 depth stays inside that bound."""
    rng = np.random.default_rng(11)
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    ps = make_courtyard_scene(3000, seed=2)
    v = ps.mesh.vertices.numpy()
    # squash every vertex into a few points: most centroids share a code
    squashed = (np.round(v / 50.0) * 50.0 + rng.uniform(0, 1e-3, v.shape)).astype(np.float32)
    rebuilt = refit_scene(ps, squashed, rebuild=True)
    depth = wide_depth(rebuilt.bvh.q_child.numpy(), rebuilt.bvh.q_leafc.numpy())
    assert 3 * 42 + 1 <= STACK_SIZES[-1]
    assert depth <= LBVH_WIDE_DEPTH <= 42, depth
    monkeypatch.setattr(cuda_traverse, "wide_depth",
                        lambda *a: pytest.fail("the rebuilt tree was read back"))
    tables = pack_trace_tables(rebuilt)
    assert (tables.depth, tables.stack) == (LBVH_WIDE_DEPTH, 128)


@pytest.mark.parametrize("rebuild", [False, True])
def test_refit_trace_tables_equal_a_fresh_pack(courtyards, rebuild):
    """After a topology refit the tables are rewritten in place (same
    tensors, same storage) and equal a fresh pack of the refit scene bit
    for bit; after a rebuild they are the fresh pack (Q internal nodes,
    8 * ceil(T/8) triangle slots)."""
    _, ps = courtyards[True]
    tables = pack_trace_tables(ps)
    ptrs = [t.data_ptr() for t in (tables.nodes, tables.tris, tables.attrs)]
    stack = tables.stack
    refit = refit_scene(ps, _moved(ps, 1.5), rebuild=rebuild)
    refit_trace_tables(tables, refit)
    fresh = pack_trace_tables(refit)
    for name in ("nodes", "tris", "attrs"):
        a, b = getattr(tables, name), getattr(fresh, name)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert tables.scene is refit
    moved_ptrs = [t.data_ptr() for t in (tables.nodes, tables.tris, tables.attrs)]
    if not rebuild:
        assert moved_ptrs == ptrs and tables.stack == stack
    else:
        assert tables.nodes.shape[0] == refit.bvh.num_nodes // 2
        assert tables.tris.shape[0] == 8 * -(-ps.num_triangles // 8)
        assert tables.stack == 128


def test_memory_stats_count_the_held_tensors(courtyards, capsys):
    js, ps = courtyards[True]
    got, want = memory_stats(ps), jax_memory_stats(js)
    assert set(got) == set(want)
    for k in ("triangles", "vertices", "bvh_nodes", "dedup_savings_bytes",
              "expanded_tri_bytes"):
        assert got[k] == want[k], k
    held = sum(t.nbytes for t in (ps.bvh.node_min, ps.bvh.node_max, ps.bvh.left, ps.bvh.right,
                                  ps.bvh.tri_start, ps.bvh.tri_count, ps.bvh.hit_link,
                                  ps.bvh.miss_link, ps.bvh.q_child, ps.bvh.q_leafc,
                                  ps.bvh.q_min, ps.bvh.q_max, ps.bvh.q_axis, ps.bvh.q_src))
    assert got["bvh_bytes"] == held
    assert got["total_bytes"] == sum(v for k, v in got.items()
                                     if k.endswith("_bytes") and k not in ("total_bytes",
                                                                           "dedup_savings_bytes"))
    print_memory_usage(ps)
    assert "triangles=" in capsys.readouterr().out
