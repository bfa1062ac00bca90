"""K3's pre-pass (csrc/camera_relative.cu): its plain version and its buffers.

`camera_relative_tables` makes the camera-relative node records and
triangle rows that K3's camera walk reads, and at node width 8 the camera
walks of K2 w8 and K2t w8. Held here, bit for bit, to a
NumPy float32 recomputation of the same operations in the walk's order, at
node widths 4 and 8, for the scene's camera and for a moved one (the camera
row is rewritten in place by `set_camera`, and the tables follow it). The
buffers the kernel writes, allocated by the wrapper at its first call: the
node records' layout (whole 128-byte lines), four float4 a triangle slot,
the shapes after a topology refit (kept) and a rebuild (allocated anew), and
the CPU route of the wrapper (the plain version; other devices refused). The walk over these tables is held to the
ordinary walk in tests/test_torch_walk_host.py; the kernel to this plain
version on the card in chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

from gpu_raytracer_tpu_torch.config import RaytracerConfig
from gpu_raytracer_tpu_torch.models.camera import Camera
from gpu_raytracer_tpu_torch.models.scene import refit_scene
from gpu_raytracer_tpu_torch.ops.cuda.build import LAUNCHES
from gpu_raytracer_tpu_torch.ops.cuda.render import (REL_TRI_WORDS, camera_relative,
                                                     camera_relative_tables, pack_render_tables,
                                                     relative_buffers, set_camera)
from gpu_raytracer_tpu_torch.ops.cuda.traverse import refit_trace_tables
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

TRIANGLES = 3000


def _same_bits(a, b):   # the code words are int32 bits, some of them NaN as floats
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _tables(width, moved, textured=True):
    cfg = RaytracerConfig(bvh_width=width)
    scene = make_courtyard_scene(TRIANGLES, seed=2, textured=textured, config=cfg, device="cpu")
    tables = pack_render_tables(scene)
    if moved:   # off every axis of the default camera, looking down and across
        set_camera(tables, Camera.create((7.25, 3.5, -11.0), (-0.4, -0.3, 0.85)))
    return tables


def _numpy_relative(nodes, tris, o, width):
    """The pre-pass in NumPy float32: every operation rounds to f32 alone."""
    o = o.astype(np.float32)
    rel_nodes = nodes.copy()
    for plane in range(6):   # lo_x, lo_y, lo_z, hi_x, hi_y, hi_z
        cols = slice(plane * width, (plane + 1) * width)
        rel_nodes[:, cols] = nodes[:, cols] - o[plane % 3]
    v0, e1, e2 = tris[:, 0:3], tris[:, 4:7], tris[:, 8:11]
    s = o[None, :] - v0
    q = np.stack([s[:, 1] * e1[:, 2] - s[:, 2] * e1[:, 1],
                  s[:, 2] * e1[:, 0] - s[:, 0] * e1[:, 2],
                  s[:, 0] * e1[:, 1] - s[:, 1] * e1[:, 0]], axis=1)
    e2q = e2[:, 0] * q[:, 0] + e2[:, 1] * q[:, 1] + e2[:, 2] * q[:, 2]
    zero = np.zeros_like(e2q)[:, None]
    rel_tris = np.concatenate([e1, e2q[:, None], e2, zero, s, zero, q, zero], axis=1)
    assert rel_tris.dtype == np.float32
    return rel_nodes, rel_tris


@pytest.mark.parametrize("textured", [True, False], ids=["textured", "untextured"])
@pytest.mark.parametrize("moved", [False, True], ids=["camera", "moved_camera"])
@pytest.mark.parametrize("width", [4, 8])
def test_plain_pre_pass_matches_numpy_bit_for_bit(width, moved, textured):
    """The tables K3's camera walk reads (the textured scene) and, at width
    8, K2 w8's (the untextured one)."""
    tables = _tables(width, moved, textured)
    tr = tables.trace
    assert tr.width == width
    o = tables.camera[:3].numpy()
    if moved:
        assert np.array_equal(o, np.float32([7.25, 3.5, -11.0]))
    rel_nodes, rel_tris = camera_relative_tables(tables)
    want_nodes, want_tris = _numpy_relative(tr.nodes.numpy(), tr.tris.numpy(), o, width)
    assert rel_nodes.dtype == torch.float32 and rel_tris.dtype == torch.float32
    assert np.array_equal(rel_nodes.numpy().view(np.int32), want_nodes.view(np.int32))
    assert np.array_equal(rel_tris.numpy().view(np.int32), want_tris.view(np.int32))
    # the codes, the axis and the pad words are the records' own bits
    assert _same_bits(rel_nodes[:, 6 * width:].contiguous(),
                      tr.nodes[:, 6 * width:].contiguous())
    # the box words moved: the camera is not at the origin
    assert not torch.equal(rel_nodes[:, :6 * width], tr.nodes[:, :6 * width])


@pytest.mark.parametrize("width", [4, 8])
def test_relative_buffers_have_the_node_layout_and_alignment(width):
    tables = _tables(width, False)
    assert tables.rel_nodes is None and tables.rel_tris is None   # none until K3's pre-pass
    tr = tables.trace
    Q, Tp = tr.nodes.shape[0], tr.tris.shape[0]
    rel_nodes, rel_tris = relative_buffers(tables)
    assert rel_nodes is tables.rel_nodes and rel_tris is tables.rel_tris
    assert rel_nodes.shape == (Q, 8 * width) and rel_nodes.dtype == torch.float32
    assert rel_nodes.shape[1] * 4 == 32 * width   # one 128-byte line a width-4 record,
    assert (32 * width) % 128 == 0                # two a width-8 one: whole lines
    assert rel_tris.shape == (Tp, REL_TRI_WORDS) and REL_TRI_WORDS * 4 == 64
    assert rel_tris.dtype == torch.float32
    assert rel_nodes.is_contiguous() and rel_tris.is_contiguous()
    assert relative_buffers(tables) == (rel_nodes, rel_tris)   # kept while the shapes hold
    # buffers of stale shapes are replaced by ones of the trace tables' shapes
    for stale in (dict(rel_nodes=torch.zeros((Q, 8 * (12 - width)))),   # the other width's
                  dict(rel_nodes=torch.zeros((Q - 1, 8 * width))),
                  dict(rel_tris=torch.zeros((Tp, 12)))):                # the ordinary rows
        t = dataclasses.replace(tables, **stale)
        got = relative_buffers(t)
        assert tuple(got[0].shape) == (Q, 8 * width) and tuple(got[1].shape) == (Tp, 16)
        assert all(g is not x for g, x in zip(got, (stale.get("rel_nodes"),
                                                    stale.get("rel_tris"))))
        assert (got[0] is rel_nodes) == ("rel_nodes" not in stale)
        assert (got[1] is rel_tris) == ("rel_tris" not in stale)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_follows_the_camera():
    tables = _tables(4, False)
    launches = LAUNCHES["k3_pre"]
    on_meta = dataclasses.replace(
        tables, trace=dataclasses.replace(tables.trace, nodes=tables.trace.nodes.to("meta"),
                                          tris=tables.trace.tris.to("meta")))
    with pytest.raises(ValueError, match="meta"):
        camera_relative(on_meta)
    assert on_meta.rel_nodes is None   # refused before anything is allocated
    rel_nodes, rel_tris = camera_relative(tables)
    assert rel_nodes is tables.rel_nodes and rel_tris is tables.rel_tris
    first = camera_relative_tables(tables)
    assert _same_bits(rel_nodes, first[0]) and _same_bits(rel_tris, first[1])
    set_camera(tables, Camera.create((-3.0, 9.5, 6.0), (0.3, -0.6, -0.7)))
    camera_relative(tables)   # the same buffers, the moved camera's values
    moved = camera_relative_tables(tables)
    assert _same_bits(tables.rel_nodes, moved[0]) and _same_bits(tables.rel_tris, moved[1])
    assert not _same_bits(moved[1], first[1])
    assert tables.rel_nodes is rel_nodes and tables.rel_tris is rel_tris
    assert LAUNCHES["k3_pre"] == launches   # no kernel on the CPU


@pytest.mark.parametrize("rebuild", [False, True], ids=["topology_refit", "rebuild"])
def test_refit_keeps_the_buffers_and_a_rebuild_allocates_them_anew(rebuild):
    tables = _tables(8, False)
    scene = tables.scene
    rel_nodes, rel_tris = camera_relative(tables)
    v = scene.mesh.vertices.numpy()
    refit_trace_tables(tables.trace, refit_scene(scene, (v * np.float32(1.1) + np.float32(0.2)),
                                                 rebuild=rebuild))
    tr = tables.trace
    assert tr.width == (4 if rebuild else 8)
    camera_relative(tables)
    # a rebuild gives width-4 node records: a new buffer; the triangle rows
    # keep theirs while the slot count holds
    assert (tables.rel_nodes is rel_nodes) == (not rebuild)
    assert (tables.rel_tris is rel_tris) == (tuple(rel_tris.shape) == tables.rel_tris.shape)
    assert tables.rel_nodes.shape == tr.nodes.shape
    assert tables.rel_tris.shape == (tr.tris.shape[0], REL_TRI_WORDS)
    want_nodes, want_tris = _numpy_relative(tr.nodes.numpy(), tr.tris.numpy(),
                                            tables.camera[:3].numpy(), tr.width)
    assert np.array_equal(tables.rel_nodes.numpy().view(np.int32), want_nodes.view(np.int32))
    assert np.array_equal(tables.rel_tris.numpy().view(np.int32), want_tris.view(np.int32))
