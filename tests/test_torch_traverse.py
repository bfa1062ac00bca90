"""The port's plain closest-hit / any-hit against the JAX package's
`ops/trace.py::trace/occluded` (its XLA path on the CPU), on seeded rays.

The plain traversal is the plain version of the CUDA traversal kernel; on a
CPU tensor the kernel wrapper takes it (checked here), on the card it is
compared with the kernel (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu.models.scene import build_default_scene as jax_default
from gpu_raytracer_tpu.ops.trace import occluded as jax_occluded
from gpu_raytracer_tpu.ops.trace import trace as jax_trace
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.ops.cuda.traverse import pack_trace_tables, traverse
from gpu_raytracer_tpu_torch.ops.trace import occluded, trace, traverse_triangles

N_RAYS = 4096


@pytest.fixture(scope="module", params=["default", "courtyard2000"])
def scenes(request):
    js = jax_default() if request.param == "default" else jax_courtyard(2000, seed=1)
    return js, port_scene_from_jax(js)


def _rays(scene, seed):
    """Origins spread over the scene's bounds (some inside boxes), unit
    directions from a normal distribution, tilted toward the geometry."""
    rng = np.random.default_rng(seed)
    lo = scene.tri_v0.numpy().min(0) - 1.0
    hi = scene.tri_v0.numpy().max(0) + 1.0
    o = rng.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    o[: N_RAYS // 2] = scene.camera.position.numpy()     # half from the camera
    d = rng.normal(size=(N_RAYS, 3))
    d[: N_RAYS // 2] += 2.0 * scene.camera.direction.numpy()
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def test_closest_hit_matches_jax(scenes):
    js, ps = scenes
    o, d = _rays(ps, 11)
    want = jax_trace(js, jnp.asarray(o), jnp.asarray(d))
    got = trace(ps, torch.from_numpy(o), torch.from_numpy(d))
    hit = np.asarray(want.hit)
    assert np.array_equal(got.hit.numpy(), hit)
    assert hit.sum() > N_RAYS // 20
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-6)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal), atol=1e-5)
    assert np.array_equal(got.material_id.numpy(), np.asarray(want.material_id))
    assert np.array_equal(got.prim_kind.numpy(), np.asarray(want.prim_kind))


def test_any_hit_matches_jax(scenes):
    js, ps = scenes
    o, d = _rays(ps, 12)
    max_t = np.random.default_rng(13).uniform(0.0, 20.0, N_RAYS).astype(np.float32)
    want = np.asarray(jax_occluded(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_t)))
    got = occluded(ps, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(max_t))
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < N_RAYS


def test_any_hit_is_closest_below_max_t(scenes):
    _, ps = scenes
    o, d = (torch.from_numpy(a) for a in _rays(ps, 14))
    max_t = torch.from_numpy(np.random.default_rng(15).uniform(0, 20, N_RAYS).astype(np.float32))
    t, _, hit, _, _ = traverse_triangles(ps, o, d, torch.full_like(max_t, 3.0e38))
    blocked = traverse_triangles(ps, o, d, max_t, any_hit=True)[2]
    assert torch.equal(blocked, hit & (t < max_t))


def test_kernel_wrapper_takes_the_plain_version_on_cpu(scenes):
    _, ps = scenes
    tables = pack_trace_tables(ps)
    o, d = (torch.from_numpy(a) for a in _rays(ps, 16))
    max_t = torch.full((N_RAYS,), 3.0e38)
    for got, want in zip(traverse(tables, o, d, max_t), traverse_triangles(ps, o, d, max_t)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_kernel_wrapper_checks_its_inputs(bad):
    ps = port_scene_from_jax(jax_default())
    tables = pack_trace_tables(ps)
    o = torch.zeros((8, 3))
    d = torch.ones((8, 3))
    max_t = torch.ones(8)
    if bad == "dtype":
        d = d.double()
    elif bad == "shape":
        max_t = torch.ones(7)
    else:
        o = torch.zeros((3, 8)).t()
    with pytest.raises(ValueError):
        traverse(tables, o, d, max_t)


def _single_leaf_scene():
    """Six triangles under one leaf: no BVH4 overlay."""
    import dataclasses

    scene = port_scene_from_jax(jax_courtyard(2000, seed=1))
    none = dict(q_child=None, q_leafc=None, q_min=None, q_max=None, q_axis=None, q_src=None)
    bvh = dataclasses.replace(scene.bvh, tri_start=torch.tensor([0]),
                              tri_count=torch.tensor([6]), **none)
    return dataclasses.replace(scene, bvh=bvh)


@pytest.mark.parametrize("name", ["default", "courtyard5000", "single_leaf"])
def test_node_records_decode_back_to_the_bvh4(name):
    """The 128-byte node record (six float4 of child boxes, one int4 of
    child codes with a leaf as its stack code and -1 for an empty slot, the
    sort axis) holds exactly the scene's BVH4: q_min, q_max, q_child,
    q_leafc and q_axis come back bit for bit."""
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import (NODE_BYTES, NODE_WORDS, unpack_nodes,
                                                           wide_arrays)

    if name == "single_leaf":
        ps = _single_leaf_scene()
    else:
        ps = port_scene_from_jax(jax_default() if name == "default" else jax_courtyard(5000, seed=2))
    tables = pack_trace_tables(ps)
    assert tables.nodes.dtype == torch.float32 and tables.nodes.shape[1] == NODE_WORDS
    assert tables.nodes.is_contiguous() and NODE_BYTES == 128
    q_min, q_max, child, count, axis, depth = wide_arrays(ps)
    assert tables.depth == depth and tables.nodes.shape[0] == child.shape[0]
    g_min, g_max, g_child, g_count, g_axis = unpack_nodes(tables.nodes)
    assert torch.equal(g_min.view(torch.int32), q_min.contiguous().view(torch.int32))
    assert torch.equal(g_max.view(torch.int32), q_max.contiguous().view(torch.int32))
    assert torch.equal(g_child, child.to(torch.int32))
    assert torch.equal(g_count, count.to(torch.int32))
    assert torch.equal(g_axis, axis.to(torch.int32))
    # the codes themselves: a leaf is what the traversal stack holds for it
    code = tables.nodes[:, 24:28].contiguous().view(torch.int32)
    leaf = count > 0
    assert leaf.any() and (code[leaf] < -1).all()
    assert torch.equal(code[leaf], (-1 - ((child[leaf] << 4) | count[leaf])).to(torch.int32))
    assert (code[(child < 0)] == -1).all() and (code[~leaf & (child >= 0)] >= 0).all()
    if name == "single_leaf":
        assert tables.nodes.shape[0] == 1 and tables.depth == 1 and tables.stack == 16
        assert code[0].tolist() == [-1 - 6, -1, -1, -1]
    elif name == "default":   # two triangles: itself a single-leaf tree
        assert not ps.bvh.has_wide and tables.nodes.shape[0] == 1
    else:
        assert ps.bvh.has_wide and tables.nodes.shape[0] > 100 and tables.depth > 2


def test_node_table_of_another_shape_or_alignment_is_refused():
    import dataclasses

    from gpu_raytracer_tpu_torch.ops.cuda.traverse import nodes_ptr

    tables = pack_trace_tables(port_scene_from_jax(jax_default()))
    old_record = torch.zeros((tables.nodes.shape[0], 36))
    with pytest.raises(ValueError, match=r"\[Q,32\]"):
        nodes_ptr(dataclasses.replace(tables, nodes=old_record))
    Q, words = tables.nodes.shape
    buf = torch.zeros(Q * words + 64, dtype=torch.float32)
    start = next(k for k in range(32) if (buf.data_ptr() + 4 * k) % 128 == 4)
    shifted = buf[start:start + Q * words].view(Q, words)
    with pytest.raises(ValueError, match="128-byte"):
        nodes_ptr(dataclasses.replace(tables, nodes=shifted))
