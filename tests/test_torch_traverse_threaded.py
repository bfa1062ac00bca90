"""K1's unordered walk: the port's `ops/cuda/traverse.py::traverse_threaded`
(on a CPU tensor its plain version, the threaded walk of
ops/bvh_traverse.py) against the JAX package's
`pallas_packet_traverse(..., ordered=False)` run in interpret mode, on the
fixture of tests/test_pallas_traverse.py (the 2,000-triangle courtyard,
32x32 camera rays in tile order).

Tolerances: both walk the binary tree left first, so hit and winner slot
are equal (no exact-t ties on this fixture); t within 1e-5 relative and
normals within 1e-5 (XLA:CPU contracts multiply-adds), materials equal.
Any hit on shadow rays toward the point light: the hit masks equal. The
node table's 32-byte records hold the tree's boxes and links, and each
leaf's first slot and count in its code."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu.ops.camera_rays import generate_rays
from gpu_raytracer_tpu.ops.packet_trace import tiled_pixel_order
from gpu_raytracer_tpu.ops.pallas.traverse import pallas_packet_traverse
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene
from gpu_raytracer_tpu_torch.ops.cuda.traverse import (THREADED_WORDS, pack_threaded_tables,
                                                      traverse_threaded)
from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles

MAX_T = np.float32(3.4028235e38 - 2.0)


@pytest.fixture(scope="module")
def courtyard():
    js = make_courtyard_scene(2000, seed=1)
    return js, port_scene_from_jax(js)


@pytest.fixture(scope="module")
def camera_rays(courtyard):
    js, _ = courtyard
    W = H = 32
    px, py = tiled_pixel_order(W, H, 32)
    o, d = generate_rays(js.camera, W, H, jnp.asarray(px), jnp.asarray(py))
    return np.asarray(o), np.asarray(d), np.full((W * H,), MAX_T, np.float32)


def _jax(js, o, d, mt, any_hit=False):
    out = pallas_packet_traverse(js.bvh, js.tri_v0, js.tri_e1, js.tri_e2, jnp.asarray(o),
                                 jnp.asarray(d), jnp.asarray(mt), tri_mat=js.tri_mat,
                                 interpret=True, ordered=False, any_hit=any_hit)
    return [np.asarray(x) for x in out]


def _port(ps, o, d, mt, any_hit=False):
    tables = pack_threaded_tables(ps)
    t = lambda a: torch.from_numpy(np.array(a))
    return [x.numpy() for x in traverse_threaded(tables, t(o), t(d), t(mt), any_hit=any_hit)]


def test_node_table_holds_the_threaded_links(courtyard):
    """32-byte records: the box, then `enter` (the left child, or a leaf's
    code -1 - (first slot << 4 | count)) and the miss link; a leaf's hit
    link is its miss link."""
    _, ps = courtyard
    tables = pack_threaded_tables(ps)
    bvh = ps.bvh
    assert THREADED_WORDS == 8
    assert tables.nodes.shape == (bvh.num_nodes, THREADED_WORDS)
    assert tables.nodes.dtype == torch.float32 and tables.nodes.is_contiguous()
    assert torch.equal(tables.nodes[:, 0:3], bvh.node_min)
    assert torch.equal(tables.nodes[:, 3:6], bvh.node_max)
    ints = tables.nodes[:, 6:8].contiguous().view(torch.int32)
    leaf = bvh.left < 0
    assert torch.equal(bvh.hit_link[leaf], bvh.miss_link[leaf])
    assert torch.equal(ints[~leaf, 0], bvh.hit_link[~leaf].to(torch.int32))
    assert torch.equal(ints[~leaf, 0], bvh.left[~leaf].to(torch.int32))
    packed = -1 - ints[leaf, 0]
    assert (ints[leaf, 0] < 0).all() and (ints[~leaf, 0] > 0).all()
    assert torch.equal(packed >> 4, bvh.tri_start[leaf].to(torch.int32))
    assert torch.equal(packed & 15, bvh.tri_count[leaf].to(torch.int32))
    assert torch.equal(ints[:, 1], bvh.miss_link.to(torch.int32))
    assert tables.lean
    # the triangle rows are K1's
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import pack_trace_tables

    assert torch.equal(tables.tris, pack_trace_tables(ps).tris)


def test_closest_hit_matches_the_jax_unordered_kernel(courtyard, camera_rays):
    js, ps = courtyard
    o, d, mt = camera_rays
    t_j, slot_j, hit_j, n_j, m_j, _ = _jax(js, o, d, mt)
    t_p, slot_p, hit_p, n_p, m_p = _port(ps, o, d, mt)
    assert hit_j.sum() > 100
    np.testing.assert_array_equal(hit_p, hit_j)
    np.testing.assert_array_equal(slot_p, slot_j)
    np.testing.assert_allclose(t_p[hit_j], t_j[hit_j], rtol=1e-5)
    np.testing.assert_array_equal(m_p, m_j)
    np.testing.assert_allclose(n_p, n_j, atol=1e-5)


def test_closest_hit_equals_the_plain_trace(courtyard, camera_rays):
    """The same walk as `ops/trace.py::traverse_triangles` (the port's plain
    K1 on a tree with more than one node): every output bit for bit."""
    _, ps = courtyard
    t = lambda a: torch.from_numpy(np.array(a))
    o, d, mt = (t(a) for a in camera_rays)
    got = traverse_threaded(pack_threaded_tables(ps), o, d, mt)
    want = traverse_triangles(ps, o, d, mt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_any_hit_matches_the_jax_unordered_kernel(courtyard, camera_rays):
    js, ps = courtyard
    o, d, mt = camera_rays
    t_p, _, hit_p, n_p, _ = _port(ps, o, d, mt)
    # shadow rays from each hit (and from a point 10 along a missed ray)
    # toward the point light, ending 1e-3 short of it
    far = np.where(hit_p, t_p, 10.0).astype(np.float32)
    point = o + d * far[:, None]
    light = np.asarray(ps.lights.position[int(np.nonzero(ps.lights.light_type.numpy() == 1)[0][0])])
    so = (point + n_p * 1e-3).astype(np.float32)
    to_light = light[None, :] - point
    dist = np.sqrt((to_light * to_light).sum(1))
    sd = (to_light / dist[:, None]).astype(np.float32)
    smax = (dist - 1e-3).astype(np.float32)
    hit_j = _jax(js, so, sd, smax, any_hit=True)[2]
    got = _port(ps, so, sd, smax, any_hit=True)
    assert 20 < hit_j.sum() < hit_j.size - 20
    np.testing.assert_array_equal(got[2], hit_j)
    # a blocker is a slot of the first blocking leaf, below max_t
    assert (got[0][got[2]] < smax[got[2]]).all() and (got[1][~got[2]] == -1).all()
