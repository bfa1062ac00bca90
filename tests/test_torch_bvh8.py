"""BVH width 8 in the port against the JAX package, on the CPU.

The width-8 overlay (`RaytracerConfig(bvh_width=8)`) bit for bit against
the JAX package's, through the bridge too; its 64-word node records, their
alignment check and the stack bound; the port's plain trace on a width-8
scene against JAX's interpreted width-8 Pallas walk (K1); the plain frame
with shadows (K2 w8's plain version) against JAX's render; the topology refit
and the rebuild of a width-8 scene; the native width-8 collapse of a
NumPy-built tree against the NumPy collapse.

Tolerance: hit masks equal, t within 1e-5 relative (the JAX test's bar),
slot and material equal except where two triangles share the exact same t
and the two walks keep different ones (counted, at most 1% of the rays)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import (assert_arrays_equal, jax_scene_arrays, port_scene_from_jax,
                          scene_to_arrays)

from gpu_raytracer_tpu.config import RaytracerConfig as JaxConfig
from gpu_raytracer_tpu.models.bvh import build_bvh as jax_build_bvh
from gpu_raytracer_tpu.models.bvh import collapse4 as jax_collapse4
from gpu_raytracer_tpu.models.scene import refit_scene as jax_refit_scene
from gpu_raytracer_tpu.ops.camera_rays import generate_rays as jax_generate_rays
from gpu_raytracer_tpu.ops.packet_trace import tiled_pixel_order as jax_tiled_pixel_order
from gpu_raytracer_tpu.ops.pallas.traverse import pallas_packet_traverse
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.engine.renderer import Renderer
from gpu_raytracer_tpu_torch.models.bvh import build_bvh, collapse4, validate_bvh
from gpu_raytracer_tpu_torch.models.bvh_native import collapse4_native
from gpu_raytracer_tpu_torch.models.scene import LBVH_DEPTH, refit_scene
from gpu_raytracer_tpu_torch.ops.cuda import traverse as k1
from gpu_raytracer_tpu_torch.ops.trace import traverse_triangles
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

W8 = RaytracerConfig(bvh_width=8)
MAX_T = np.float32(3.4028235e38 - 2.0)
MAX_TIE_SHARE = 0.01


@pytest.fixture(scope="module")
def courtyards():
    """(JAX, port) width-8 courtyards of 2000 triangles, and the port's width-4 one."""
    js = jax_courtyard(2000, seed=1, config=JaxConfig(bvh_width=8))
    ps = make_courtyard_scene(2000, seed=1, config=W8)
    return js, ps, make_courtyard_scene(2000, seed=1)


def test_width8_overlay_is_bit_equal_to_jax(courtyards):
    js, ps, _ = courtyards
    a, b = jax_scene_arrays(js), scene_to_arrays(ps)
    assert b["bvh.q_child"].shape[1] == 8 and b["bvh.q_min"].shape[1:] == (8, 3)
    for key in ("q_child", "q_leafc", "q_min", "q_max", "q_axis", "q_src"):
        assert_arrays_equal({key: a[f"bvh.{key}"]}, {key: b[f"bvh.{key}"]})
    assert_arrays_equal(a, b)
    assert_arrays_equal(scene_to_arrays(port_scene_from_jax(js)), b)


def test_width8_shares_the_binary_tree_and_slots_of_width4(courtyards):
    """Width 4 and width 8 collapse one binary tree over one slot order: only
    the overlay differs, so the plain path renders the same frame."""
    _, p8, p4 = courtyards
    a, b = scene_to_arrays(p8), scene_to_arrays(p4)
    overlay = {k for k in a if k.startswith("bvh.q_")}
    assert_arrays_equal(a, b, skip=overlay)
    assert p8.bvh.q_child.shape[0] < p4.bvh.q_child.shape[0]
    f8 = Renderer(p8, 48, 32, shadows=True, device="cpu").render()
    f4 = Renderer(p4, 48, 32, shadows=True, device="cpu").render()
    assert np.array_equal(f8, f4) and f8.max() > 0.05


def test_node_records_round_trip_at_width_8(courtyards):
    """A width-8 record is 64 words (12 float4 of boxes, 2 int4 of codes, the
    axis, 7 pad words): pack_nodes / unpack_nodes give the arrays back bit
    for bit, and the codes are the stack's leaf codes."""
    _, ps, _ = courtyards
    tables = k1.pack_trace_tables(ps)
    assert tables.width == 8 and tables.nodes.shape == (ps.bvh.q_child.shape[0], 64)
    q_min, q_max, child, count, axis, depth = k1.wide_arrays(ps)
    assert tables.depth == depth and child.shape[1] == 8
    g_min, g_max, g_child, g_count, g_axis = k1.unpack_nodes(tables.nodes)
    assert torch.equal(g_min.view(torch.int32), q_min.contiguous().view(torch.int32))
    assert torch.equal(g_max.view(torch.int32), q_max.contiguous().view(torch.int32))
    assert torch.equal(g_child, child) and torch.equal(g_count, count)
    assert torch.equal(g_axis, axis)
    code = tables.nodes[:, 48:56].contiguous().view(torch.int32)
    leaf = (child >= 0) & (count > 0)
    assert torch.equal(code[leaf], -1 - ((child[leaf] << 4) | count[leaf]))
    assert (code[child < 0] == -1).all()
    assert not tables.nodes[:, 57:].any()
    assert torch.equal(k1.pack_nodes(g_min, g_max, g_child, g_count, g_axis).view(torch.int32),
                       tables.nodes.view(torch.int32))
    with pytest.raises(ValueError, match="4 or 8"):
        k1.pack_nodes(q_min[:, :6], q_max[:, :6], child[:, :6], count[:, :6], axis)


def _aligned(rows: int, words: int, offset_words: int = 0) -> torch.Tensor:
    """A contiguous [rows, words] f32 view starting offset_words past a
    128-byte boundary."""
    buf = torch.zeros(rows * words + 64, dtype=torch.float32)
    start = (-(buf.data_ptr() // 4)) % 32 + offset_words
    return buf[start:start + rows * words].view(rows, words)


def test_nodes_ptr_takes_q64_tables_and_refuses_others(courtyards):
    _, ps, _ = courtyards
    tables = k1.pack_trace_tables(ps)
    Q = tables.nodes.shape[0]
    ok = _aligned(Q, 64)
    assert k1.nodes_ptr(dataclasses.replace(tables, nodes=ok)) == ok.data_ptr()
    with pytest.raises(ValueError, match="128-byte"):
        k1.nodes_ptr(dataclasses.replace(tables, nodes=_aligned(Q, 64, offset_words=16)))
    for words in (32, 48, 128):   # another record size than the tables' width
        with pytest.raises(ValueError, match=r"\[Q,64\]"):
            k1.nodes_ptr(dataclasses.replace(tables, nodes=_aligned(Q, words)))
    with pytest.raises(ValueError, match=r"\[Q,32\]"):   # a width-4 table of 64-word rows
        k1.nodes_ptr(dataclasses.replace(tables, nodes=ok, width=4))
    with pytest.raises(ValueError):
        k1.nodes_ptr(dataclasses.replace(tables, nodes=ok.double()))
    with pytest.raises(ValueError):
        k1.nodes_ptr(dataclasses.replace(tables, nodes=ok.t()))


def test_stack_capacity_at_width_8():
    """(w - 1) * depth + 1 entries: 7 * depth + 1 at width 8, from the stacks
    compiled at that width (no 16-entry stack)."""
    got = [k1.stack_capacity(d, 8) for d in (1, 4, 5, 9, 10, 18)]
    assert got == [32, 32, 64, 64, 128, 128]
    assert [k1.stack_capacity(d) for d in (5, 6)] == [16, 32]   # width 4 unchanged
    with pytest.raises(ValueError, match="134-entry"):
        k1.stack_capacity(19, 8)
    with pytest.raises(ValueError, match="widths 4 and 8"):
        k1.stack_capacity(3, 6)


def test_courtyard_tables_take_the_stack_of_their_depth(courtyards):
    _, ps, _ = courtyards
    tables = k1.pack_trace_tables(ps)
    assert tables.depth == k1.wide_depth(ps.bvh.q_child.numpy(), ps.bvh.q_leafc.numpy())
    assert 7 * tables.depth + 1 <= tables.stack and tables.stack in k1.WIDE_STACK_SIZES[8]


def test_plain_trace_matches_jax_interpreted_width8_kernel(courtyards):
    """The port's plain trace on the width-8 scene (the plain version of the
    width-8 kernels) against the JAX package's width-8 Pallas walk run by
    the interpreter, on its own test's 32 x 32 camera rays."""
    js, ps, _ = courtyards
    W = H = 32
    px, py = jax_tiled_pixel_order(W, H, 32)
    o, d = jax_generate_rays(js.camera, W, H, jnp.asarray(px), jnp.asarray(py))
    mt = jnp.full((o.shape[0],), MAX_T, jnp.float32)
    jt, jslot, jhit, _, jmat, _ = pallas_packet_traverse(
        js.bvh, js.tri_v0, js.tri_e1, js.tri_e2, o, d, mt, tri_mat=js.tri_mat,
        interpret=True, ordered=True)
    to = lambda a: torch.from_numpy(np.array(a))
    t, slot, hit, _, mat = traverse_triangles(ps, to(o), to(d), to(mt))
    jhit, jt, jslot, jmat = (np.asarray(a) for a in (jhit, jt, jslot, jmat))
    assert np.array_equal(hit.numpy(), jhit) and jhit.sum() > 100
    np.testing.assert_allclose(t.numpy()[jhit], jt[jhit], rtol=1e-5)
    other = jhit & (slot.numpy() != jslot)
    ties = other & (t.numpy() == jt)
    assert not (other & ~ties).any()
    assert ties.sum() <= MAX_TIE_SHARE * jhit.size
    assert np.array_equal(mat.numpy()[jhit & ~ties], jmat[jhit & ~ties])
    # the K1 wrapper on CPU tensors is that plain trace
    tables = k1.pack_trace_tables(ps)
    got = k1.traverse(tables, to(o), to(d), to(mt))
    for a, b in zip(got, traverse_triangles(ps, to(o), to(d), to(mt))):
        assert torch.equal(a, b)


def _moved(scene, scale):
    v = np.asarray(scene.mesh.vertices, np.float32)
    return (v * np.float32(scale) + np.float32([0.1, 0.2, -0.3])).astype(np.float32)


@pytest.mark.parametrize("rebuild", [False, True])
def test_width8_refit_matches_jax(courtyards, rebuild):
    """A topology refit keeps the width-8 overlay (its boxes gathered through
    q_src [Q,8]); a rebuild is a width-4 LBVH, in both packages."""
    js, ps, _ = courtyards
    moved = _moved(js, 1.3)
    want = jax_refit_scene(js, jnp.asarray(moved), rebuild=rebuild)
    got = refit_scene(ps, moved, rebuild=rebuild)
    assert_arrays_equal(scene_to_arrays(got), jax_scene_arrays(want))
    assert got.bvh.q_child.shape[1] == (4 if rebuild else 8)
    assert got.bvh.depth == (LBVH_DEPTH if rebuild else ps.bvh.depth)


@pytest.mark.parametrize("rebuild", [False, True])
def test_width8_refit_tables_equal_a_fresh_pack(courtyards, rebuild):
    """After a topology refit of a width-8 scene its tables stay width 8,
    rewritten in place and bit-equal to a fresh pack; after a rebuild they
    are a fresh width-4 pack with the 128-entry stack."""
    _, ps, _ = courtyards
    tables = k1.pack_trace_tables(ps)
    nodes = tables.nodes
    refit = refit_scene(ps, _moved(ps, 1.5), rebuild=rebuild)
    k1.refit_trace_tables(tables, refit)
    fresh = k1.pack_trace_tables(refit)
    for name in ("nodes", "tris", "attrs"):
        assert torch.equal(getattr(tables, name).view(torch.int32),
                           getattr(fresh, name).view(torch.int32)), name
    assert (tables.width, tables.depth, tables.stack) == (fresh.width, fresh.depth, fresh.stack)
    if rebuild:
        assert tables.width == 4 and tables.nodes.shape[1] == 32 and tables.stack == 128
    else:
        assert tables.width == 8 and tables.nodes is nodes


@pytest.mark.parametrize("size", [(32, 32), (64, 48)])
def test_width8_frame_with_shadows_matches_jax(courtyards, size):
    """K2 w8's plain version: the port's Renderer on the CPU (`render_chunk`)
    on the width-8 courtyard, shadows on, against the JAX package's Renderer
    on its width-8 courtyard (its XLA path on the CPU): within 1e-5, outside
    the counted rounding-sensitive pixels (torch_bridge: f16 attenuation
    boundaries where XLA:CPU's fused multiply-add moves the rounding, and
    pixels that f32 rounding alone moves by more than 1e-6), at most 1% of
    the frame."""
    from gpu_raytracer_tpu.engine.renderer import Renderer as JaxRenderer
    from gpu_raytracer_tpu_torch.ops.camera_rays import generate_rays
    from gpu_raytracer_tpu_torch.ops.trace import trace
    from torch_bridge import f16_attenuation_flips, rounding_sensitive_pixels

    js, ps, _ = courtyards
    W, H = size
    want = np.asarray(JaxRenderer(js, W, H, shadows=True).render())
    got = Renderer(ps, W, H, shadows=True, device="cpu").render()
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all() and got.max() > 0.05
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.int32),
                            torch.arange(W, dtype=torch.int32), indexing="ij")
    o, d = generate_rays(ps.camera, W, H, px.reshape(-1), py.reshape(-1))
    counted = (f16_attenuation_flips(ps, trace(ps, o, d)).reshape(H, W)
               | rounding_sensitive_pixels(ps, W, H, shadows=True))
    assert counted.sum() <= MAX_TIE_SHARE * counted.size
    diff = np.abs(got - want).max(axis=-1)
    assert diff[~counted].max() <= 1e-5
    print(f"width 8 {W}x{H}, shadows: max |diff| {diff[~counted].max():.3g} outside "
          f"{int(counted.sum())} counted pixels ({diff.max():.3g} on them)")


def test_native_width8_collapse_of_a_numpy_tree_equals_the_numpy_collapse():
    """The JAX package's test_bvh.py width-8 case: on a NumPy-built tree the
    native collapse equals the NumPy one, in the port and in JAX, and every
    leaf range is referenced exactly once."""
    rng = np.random.default_rng(4)
    verts = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    idx = rng.integers(0, 3000, (2000, 3)).astype(np.uint32)
    res = build_bvh(verts, idx, leaf_size=8, use_native=False)
    validate_bvh(res, idx.shape[0])
    args = (res.left, res.right, res.tri_start, res.tri_count, res.node_min, res.node_max)
    got = collapse4_native(*args, width=8)
    want = collapse4(*args, width=8)
    jres = jax_build_bvh(verts, idx, leaf_size=8, use_native=False)
    jwant = jax_collapse4(jres.left, jres.right, jres.tri_start, jres.tri_count,
                          jres.node_min, jres.node_max, width=8)
    for g, w, j in zip(got, want, jwant):
        assert g.dtype == w.dtype and np.array_equal(g.view(np.int32), w.view(np.int32))
        assert np.array_equal(w.view(np.int32), np.asarray(j).view(np.int32))
    q_child, q_leafc = got[0], got[1]
    assert q_child.shape[1] == 8
    leaf_slots = q_leafc > 0
    starts = np.sort(q_child[leaf_slots])
    leaves = np.nonzero((res.left < 0) & (res.tri_count > 0))[0]
    assert np.array_equal(starts, np.sort(res.tri_start[leaves]))
