"""The port's multi-device layer (gpu_raytracer_tpu_torch/parallel/) on an
8-shard CPU mesh, mirroring tests/test_parallel.py case by case: each case
against the JAX function on JAX's 8-device CPU mesh (tests/conftest.py)
and against the port's own single-device result.

Tolerances:
  * against the port's single device: 0.0 for frames, steps and traces
    (each shard runs the same plain code on its block or sub-BVH; the
    sharded trace's t is bit-equal, its normal and uv within 1e-6);
  * against JAX's sharded functions: the JAX tests' bars where they hold
    between the packages (the fused frames 2e-5 and 3e-4, hits and
    materials equal, t within 1e-5 relative), else the port's parity bars
    of the single-device tests: the ray-sharded frame within 1e-5
    (tests/test_torch_render.py; JAX's 1e-6 holds its sharded frame to its
    own single device, the same XLA code, and the port's frame is 0.0 from
    its own), the step 99% of the pixels within 1e-5 and counts within 1%
    of the pool (tests/test_torch_pathtracer.py); the per-shard tables bit
    for bit;
  * `prim_id` of the sharded traces is the ORIGINAL mesh id in both
    packages: the single device's winner slot mapped through tri_src.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_bridge import port_scene_from_jax

from gpu_raytracer_tpu import build_default_scene as jax_default_scene
from gpu_raytracer_tpu.engine.pathtracer import PathTracer as JaxPathTracer
from gpu_raytracer_tpu.parallel import mesh as jmesh
from gpu_raytracer_tpu.parallel import shard as jshard
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
from gpu_raytracer_tpu_torch.engine.renderer import Renderer, render_image
from gpu_raytracer_tpu_torch.ops.cuda.bounce import pack_bounce_tables
from gpu_raytracer_tpu_torch.ops.cuda.render import pack_render_tables, render_deferred
from gpu_raytracer_tpu_torch.ops.cuda.texshade import pack_shade_tables, texture_shade
from gpu_raytracer_tpu_torch.ops.trace import TRIANGLE, trace
from gpu_raytracer_tpu_torch.parallel.mesh import (Mesh, gather, make_mesh, pmin,
                                                   ppermute_next, psum)
from gpu_raytracer_tpu_torch.parallel.shard import (INT_MAX, GeometryShards,
                                                    pathtrace_step_sharded,
                                                    render_frame_fused_multichip,
                                                    render_frame_multichip, replicate_tables,
                                                    trace_geometry_sharded,
                                                    trace_geometry_sharded_ring)

D = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(D, device="cpu")


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < D:
        pytest.skip("needs 8 virtual JAX devices (tests/conftest.py)")
    return jmesh.make_mesh(D)


@pytest.fixture(scope="module")
def default_pair():
    js = jax_default_scene()
    return js, port_scene_from_jax(js)


@pytest.fixture(scope="module")
def courtyard_pair():
    js = jax_courtyard(target_triangles=3_000, seed=2)
    return js, port_scene_from_jax(js)


def _rays(seed, m, spread, aim):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (m, 3)).astype(np.float32)
    d = rng.uniform(-aim, aim, (m, 3)).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


# ---- the mesh and its collectives ----

def test_mesh_shards_and_collectives():
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4
    assert make_mesh(device="cpu").size == 1
    x = torch.arange(8.0)
    assert [b.tolist() for b in mesh.split(x)] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        mesh.split(torch.arange(6.0))
    copies = mesh.replicate(x)
    assert all(c is copies[0] for c in copies)   # one copy per distinct device
    xs = [torch.tensor([3.0, -1.0]), torch.tensor([1.0, 5.0]), torch.tensor([2.0, 0.0]),
          torch.tensor([4.0, 2.0])]
    assert pmin(mesh, xs)[2].tolist() == [1.0, -1.0]
    assert psum(mesh, xs)[0].tolist() == [10.0, 6.0]
    assert [v.tolist() for v in ppermute_next(mesh, xs)] == [[4.0, 2.0], [3.0, -1.0],
                                                             [1.0, 5.0], [2.0, 0.0]]
    assert gather(mesh, xs).tolist() == [3.0, -1.0, 1.0, 5.0, 2.0, 0.0, 4.0, 2.0]
    assert isinstance(mesh, Mesh)


# ---- ray sharding ----

def test_ray_sharded_render_matches_single_and_jax(mesh, jax_mesh, default_pair):
    js, ps = default_pair
    W = H = 32
    img = render_frame_multichip(replicate_tables(mesh, ps), W, H, mesh)
    np.testing.assert_array_equal(img, render_image(ps, W, H, device="cpu"))
    want = jshard.render_frame_multichip(js, W, H, jax_mesh)
    np.testing.assert_allclose(img, want, atol=1e-5)


@pytest.mark.parametrize("textured", [False, True])
def test_fused_frame_matches_single_and_jax(mesh, jax_mesh, default_pair, textured):
    """Untextured: the default scene at 32x32 through K2's plain version;
    textured: the 1,500-triangle courtyard at 64x32 with shadows through
    K3 + K4's plain versions (JAX's bars 2e-5 and 3e-4 against its own
    single device hold against the port's frame too)."""
    if textured:
        js = jax_courtyard(target_triangles=1500, seed=1, textured=True)
        ps, W, H, shadows, bar = port_scene_from_jax(js), 64, 32, True, 3e-4
    else:
        (js, ps), W, H, shadows, bar = default_pair, 32, 32, False, 2e-5
    tables = replicate_tables(mesh, ps)
    shade = replicate_tables(mesh, ps, pack_shade_tables) if textured else None
    fb = render_frame_fused_multichip(tables, W, H, mesh, shadows=shadows, shade_tables=shade)
    if textured:
        # the single device's two phases over the whole frame
        t, s = pack_render_tables(ps), pack_shade_tables(ps)
        r = Renderer(ps, W, H, shadows=True, device="cpu")
        flat = texture_shade(s, render_deferred(t, r.px, r.py, W, H, shadows=True))
        single = r.to_image(flat.numpy())
    else:
        single = Renderer(ps, W, H, device="cpu").render()
    np.testing.assert_array_equal(fb, single)
    want = jshard.render_frame_fused_multichip(js, W, H, jax_mesh, shadows=shadows,
                                               interpret=True)
    np.testing.assert_allclose(fb, want, atol=bar)


def test_textured_fused_frame_needs_shade_tables(mesh):
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    scene = make_courtyard_scene(300, textured=True)
    with pytest.raises(ValueError, match="shade_tables"):
        render_frame_fused_multichip(replicate_tables(mesh, scene), 16, 16, mesh)


def test_pathtrace_step_sharded_matches_single_and_jax(mesh, jax_mesh, default_pair):
    js, ps = default_pair
    W = H = 32
    pt = PathTracer(ps, W, H, shadows=True, spectral=True, device="cpu")
    pt.step()
    acc, counts = pathtrace_step_sharded(
        replicate_tables(mesh, ps, pack_bounce_tables), torch.zeros_like(pt.accum), 0,
        pt._px, pt._py, mesh, width=W, height=H, channel=3,
        max_depth=pt.config.max_bounce_depth, rr_start=pt.config.russian_roulette_start,
        qmc=True, qmc_seed=pt._qmc_seed)
    np.testing.assert_allclose(acc.numpy(), pt.accum.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(counts, pt._last_counts)
    jp = JaxPathTracer(js, W, H, shadows=True, spectral=True)
    jacc, jcounts = jshard.pathtrace_step_sharded(
        js, jp.accum, jp.key, 0, jp._px, jp._py, jax_mesh, width=W, height=H, channel=3,
        max_depth=jp.config.max_bounce_depth, rr_start=jp.config.russian_roulette_start,
        leaf_size=jp.config.bvh_leaf_size, use_bvh=jp.use_bvh, qmc=True, qmc_seed=jp._qmc_seed)
    assert np.array_equal(pt._px.numpy(), np.asarray(jp._px))
    diff = np.abs(acc.numpy() - np.asarray(jacc)).max(axis=1)
    assert (diff <= 1e-5).mean() >= 0.99, f"{(diff <= 1e-5).mean():.4f} within 1e-5"
    assert np.abs(counts.numpy() - np.asarray(jcounts)).max() <= 0.01 * W * H


def test_rng_step_draws_its_own_stream_per_shard(default_pair):
    """sampler "rng": each shard seeds its own streams; the counts' first
    depth is every lane, and the sum is finite and not the QMC sample."""
    _, ps = default_pair
    mesh = make_mesh(2, device="cpu")
    W = H = 16
    pt = PathTracer(ps, W, H, device="cpu")
    tables = replicate_tables(mesh, ps, pack_bounce_tables)
    args = (tables, torch.zeros_like(pt.accum), 0, pt._px, pt._py, mesh)
    rng, counts = pathtrace_step_sharded(*args, width=W, height=H, qmc=False, rng_seed=7)
    qmc, _ = pathtrace_step_sharded(*args, width=W, height=H)
    assert int(counts[0]) == W * H and torch.isfinite(rng).all()
    assert not torch.equal(rng, qmc)
    again, _ = pathtrace_step_sharded(*args, width=W, height=H, qmc=False, rng_seed=7)
    assert torch.equal(again, rng)


# ---- geometry sharding ----

def _node_fields(bvh):
    return dict(node_min=bvh.node_min, node_max=bvh.node_max, left=bvh.left, right=bvh.right,
                tri_start=bvh.tri_start, tri_count=bvh.tri_count, hit_link=bvh.hit_link,
                miss_link=bvh.miss_link)


def _assert_shards_equal_jax(shards, jshards):
    """Every shard's arrays equal JAX's stacked arrays sliced to the shard,
    bit for bit, and JAX's padding beyond them is its filler."""
    assert shards.n_shards == jshards.n_shards and shards.max_leaf == jshards.max_leaf
    for i, s in enumerate(shards.shards):
        bvh, sc = s.scene.bvh, s.scene
        for name, x in _node_fields(bvh).items():
            want = np.asarray(getattr(jshards, name)[i])
            assert np.array_equal(x.numpy(), want[:x.shape[0]]), (i, name)
        for name, x in dict(tri_v0=sc.tri_v0, tri_e1=sc.tri_e1, tri_e2=sc.tri_e2,
                            tri_mat=sc.tri_mat, tri_uv=sc.tri_uv, orig_id=s.orig_id).items():
            want = np.asarray(getattr(jshards, name)[i])
            assert np.array_equal(x.numpy(), want[:x.shape[0]]), (i, name)
            if name == "orig_id":
                assert (want[x.shape[0]:] == INT_MAX).all()
        for name in ("q_child", "q_leafc", "q_min", "q_max", "q_axis"):
            x = getattr(bvh, name)
            want = np.asarray(getattr(jshards, name)[i])
            assert np.array_equal(x.numpy(), want[:x.shape[0]]), (i, name)


def test_geometry_shards_equal_jax_on_the_courtyard(mesh, courtyard_pair):
    js, ps = courtyard_pair
    shards = GeometryShards(ps, mesh)
    _assert_shards_equal_jax(shards, jshard.GeometryShards(js, D))
    ids = torch.cat([s.orig_id[s.orig_id != INT_MAX] for s in shards.shards])
    assert torch.equal(torch.sort(ids.long())[0], torch.arange(ps.num_triangles))
    assert all(s.scene.bvh.num_nodes < ps.bvh.num_nodes for s in shards.shards)
    assert all(s.tables.nodes.shape[1] == 32 for s in shards.shards)


def test_geometry_shards_inert_and_single_node_quad_root(mesh, default_pair):
    """8 shards over the default scene's 2 triangles: two one-triangle
    shards and six INERT ones (zero edges, id INT_MAX), every one a single
    node under JAX's synthesised quad root (the node's box in slot 0)."""
    js, ps = default_pair
    shards = GeometryShards(ps, mesh)
    _assert_shards_equal_jax(shards, jshard.GeometryShards(js, D))
    live = [bool((s.orig_id != INT_MAX).any()) for s in shards.shards]
    assert sum(live) == 2
    for s, is_live in zip(shards.shards, live):
        bvh = s.scene.bvh
        assert bvh.num_nodes == 1 and bvh.q_child.tolist() == [[int(bvh.tri_start[0]), -1, -1, -1]]
        assert torch.equal(bvh.q_min[0, 0], bvh.node_min[0])
        assert torch.equal(bvh.q_max[0, 0], bvh.node_max[0])
        assert (bvh.q_min[0, 1:] == 1e30).all()
        if not is_live:
            assert not s.scene.tri_e1.any() and not s.scene.tri_e2.any()
            assert (s.orig_id == INT_MAX).all()


def _hold(sharded, single, scene, rows=slice(None)):
    """The sharded Hit against the single-device trace's rows: hit,
    material, prim_kind and t equal, prim_id the winner's original id,
    normal and uv within 1e-6."""
    h = single.hit[rows]
    assert torch.equal(sharded.hit, h)
    assert torch.equal(sharded.material_id, single.material_id[rows])
    assert torch.equal(sharded.prim_kind, single.prim_kind[rows])
    assert torch.equal(sharded.t, single.t[rows])
    tri = single.prim_kind[rows] == TRIANGLE
    orig = scene.tri_src[single.prim_id[rows].clamp(min=0)].long()
    want_id = torch.where(tri, orig, single.prim_id[rows])
    assert torch.equal(sharded.prim_id, want_id)
    assert (sharded.normal - single.normal[rows]).abs().max() <= 1e-6
    if scene.textures.textured:
        assert (sharded.uv - single.uv[rows]).abs().max() <= 1e-6


def _hold_jax(sharded, jhit):
    h = np.asarray(jhit.hit)
    assert np.array_equal(sharded.hit.numpy(), h)
    np.testing.assert_allclose(sharded.t.numpy()[h], np.asarray(jhit.t)[h], rtol=1e-5)
    assert np.array_equal(sharded.material_id.numpy()[h], np.asarray(jhit.material_id)[h])
    assert np.array_equal(sharded.prim_kind.numpy()[h], np.asarray(jhit.prim_kind)[h])
    assert np.array_equal(sharded.prim_id.numpy()[h], np.asarray(jhit.prim_id)[h])
    np.testing.assert_allclose(sharded.normal.numpy()[h], np.asarray(jhit.normal)[h], atol=1e-5)
    np.testing.assert_allclose(sharded.uv.numpy()[h], np.asarray(jhit.uv)[h], atol=1e-5)


@pytest.mark.parametrize("ring", [False, True])
def test_geometry_trace_matches_single_and_jax(mesh, jax_mesh, courtyard_pair, ring):
    """The courtyard of 3,000 triangles over 8 sub-BVHs, 2,048 rays (256 a
    shard block in the ring) and the odd 1,003-ray batch (block padding)."""
    js, ps = courtyard_pair
    shards = GeometryShards(ps, mesh)
    fn = trace_geometry_sharded_ring if ring else trace_geometry_sharded
    jfn = jshard.trace_geometry_sharded_ring if ring else jshard.trace_geometry_sharded
    o, d = _rays(13, 2048, 30.0, 15.0)
    to = lambda a: torch.from_numpy(a)
    single = trace(ps, to(o), to(d))
    assert single.hit.sum() > 200
    for n in (2048, 1003):
        got = fn(ps, to(o[:n]), to(d[:n]), mesh, shards)
        _hold(got, single, ps, slice(0, n))
        _hold_jax(got, jfn(js, jnp.asarray(o[:n]), jnp.asarray(d[:n]), jax_mesh))


def test_geometry_trace_inert_shards_match_single_and_jax(mesh, jax_mesh, default_pair):
    """Rays aimed at the default scene's two triangles over 8 shards, six of
    them inert: attributes summed once, as on one device."""
    js, ps = default_pair
    cent = np.asarray([[0.0, 1.0 / 3.0, -2.0], [1.5, -1.0 / 6.0, -3.0]], np.float32)
    n = 128
    o = np.tile(np.asarray([[0.0, 2.0, 2.0]], np.float32), (n, 1))
    jit = np.random.default_rng(5).uniform(-0.25, 0.25, (n, 3)).astype(np.float32)
    d = np.repeat(cent, n // 2, axis=0) + jit - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    shards = GeometryShards(ps, mesh)
    single = trace(ps, torch.from_numpy(o), torch.from_numpy(d))
    assert (single.hit & (single.prim_kind == TRIANGLE)).sum() > 32
    for fn, jfn in ((trace_geometry_sharded, jshard.trace_geometry_sharded),
                    (trace_geometry_sharded_ring, jshard.trace_geometry_sharded_ring)):
        got = fn(ps, torch.from_numpy(o), torch.from_numpy(d), mesh, shards)
        _hold(got, single, ps)
        _hold_jax(got, jfn(js, jnp.asarray(o), jnp.asarray(d), jax_mesh))


def test_geometry_shards_must_match_the_mesh(mesh, default_pair):
    _, ps = default_pair
    shards = GeometryShards(ps, make_mesh(2, device="cpu"))
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3).contiguous()
    for fn in (trace_geometry_sharded, trace_geometry_sharded_ring):
        with pytest.raises(ValueError, match="geometry shards"):
            fn(ps, o, d, mesh, shards)
