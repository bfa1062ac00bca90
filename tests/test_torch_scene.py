"""The PyTorch port's host-side scene build against the JAX package's.

Both build from the same seeds; the prepared tables must agree field by
field, floats bit for bit: the leaf-ordered triangle table decides which
triangle wins an exact-t tie in every traversal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_bridge import (assert_arrays_equal, canonical_binary_tree, jax_scene_arrays,
                          port_scene_from_jax, scene_to_arrays)

from gpu_raytracer_tpu.config import RaytracerConfig as JaxConfig
from gpu_raytracer_tpu.models.camera import Camera as JaxCamera
from gpu_raytracer_tpu.models.camera import CameraController as JaxController
from gpu_raytracer_tpu.models.scene import build_default_scene as jax_default
from gpu_raytracer_tpu.ops import f16 as jax_f16
from gpu_raytracer_tpu.utils.procgen import make_courtyard_scene as jax_courtyard
from gpu_raytracer_tpu_torch import config as port_config
from gpu_raytracer_tpu_torch.models.bvh_native import load_builder
from gpu_raytracer_tpu_torch.models.camera import Camera, CameraController
from gpu_raytracer_tpu_torch.models.scene import build_default_scene
from gpu_raytracer_tpu_torch.ops import f16
from gpu_raytracer_tpu_torch.ops.cuda.traverse import STACK_SIZES, pack_trace_tables
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

SCENES = {
    "default": (jax_default, build_default_scene),
    "courtyard2000": (lambda: jax_courtyard(2000, seed=1),
                      lambda: make_courtyard_scene(2000, seed=1)),
    "courtyard3000_4lights": (lambda: jax_courtyard(3000, seed=5, lights=4),
                              lambda: make_courtyard_scene(3000, seed=5, lights=4)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    jax_fn, port_fn = SCENES[request.param]
    return jax_fn(), port_fn()


def test_scene_bit_equal(scene_pair):
    js, ps = scene_pair
    assert_arrays_equal(jax_scene_arrays(js), scene_to_arrays(ps))


def test_bridge_carries_the_jax_scene(scene_pair):
    js, ps = scene_pair
    carried = port_scene_from_jax(js)
    assert_arrays_equal(scene_to_arrays(carried), scene_to_arrays(ps))
    for f in dataclasses.fields(carried):
        v = getattr(carried, f.name)
        if isinstance(v, torch.Tensor):
            assert v.dtype == getattr(ps, f.name).dtype, f.name


def test_courtyard_100k_build():
    """The real-size scene: every table bit-equal, the binary tree compared
    after relabelling its nodes in depth-first order."""
    js = jax_courtyard(100_000, seed=0)
    ps = make_courtyard_scene(100_000, seed=0)
    assert ps.num_triangles == 99_920 and ps.bvh.leaf_align == 8
    a = canonical_binary_tree(jax_scene_arrays(js))
    b = canonical_binary_tree(scene_to_arrays(ps))
    assert_arrays_equal(a, b)
    assert ps.bvh.num_nodes == 38_967 and ps.bvh.q_child.shape == (9_121, 4)


def test_native_builder_loads():
    b = load_builder()
    assert b.origin in ("committed", "compiled")
    assert hasattr(b.lib, "bvh_build") and hasattr(b.lib, "bvh_collapse_wide")


def test_scene_moves_between_devices(scene_pair):
    _, ps = scene_pair
    moved = ps.to("cpu")
    assert moved.device == torch.device("cpu")
    assert_arrays_equal(scene_to_arrays(moved), scene_to_arrays(ps))


def test_config_matches():
    """The port's fields are the JAX package's, in its order and with its
    defaults, but for the five only its TPU path reads."""
    tpu_only = {"ray_batch_size", "bvh_stack_depth", "pathtrace_samples_per_step", "dtype",
                "use_pallas"}
    assert ([(f.name, f.default) for f in dataclasses.fields(JaxConfig) if f.name not in tpu_only]
            == [(f.name, f.default) for f in dataclasses.fields(port_config.RaytracerConfig)])


def test_f16_helpers_bit_equal():
    rng = np.random.default_rng(7)
    lo = rng.uniform(-60000, 60000, 512).astype(np.float32)
    hi = np.concatenate([rng.uniform(-2, 2, 256), rng.uniform(-1e-5, 1e-5, 256)]).astype(np.float32)
    packed = f16.pack_f16_pair(lo, hi)
    assert np.array_equal(packed, jax_f16.pack_f16_pair(lo, hi))
    t = torch.from_numpy(packed.astype(np.int64))
    for port_fn, jax_fn in ((f16.unpack_f16_low, jax_f16.unpack_f16_low),
                            (f16.unpack_f16_high, jax_f16.unpack_f16_high)):
        got = port_fn(t).numpy()
        want = np.asarray(jax_fn(jnp.asarray(packed)))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    x = np.concatenate([rng.uniform(0, 1, 512), rng.uniform(0, 1e-4, 512)]).astype(np.float32)
    got = f16.f16_roundtrip(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32),
                          np.asarray(jax_f16.f16_roundtrip(jnp.asarray(x))).view(np.uint32))


def test_camera_controller_matches():
    cams = (Camera.create((1.0, 2.0, 3.0), (0.2, -0.1, -1.0), fov=50.0),
            JaxCamera.create((1.0, 2.0, 3.0), (0.2, -0.1, -1.0), fov=50.0))
    ctrls = [CameraController(cams[0]), JaxController(cams[1])]
    for c in ctrls:
        c.rotate(30.0, -12.0)
        c.move(forward=2.0, strafe=-1.0)
        c.rotate(-5.0, 400.0)
    a, b = ctrls[0].camera(), ctrls[1].camera()
    for f in ("position", "direction", "up", "fov"):
        assert np.array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f))), f


@pytest.mark.parametrize("name", ["default", "courtyard2000"])
def test_trace_tables_encode_the_bvh4(name):
    """The GPU node records decode back to the BVH4 overlay (or to the one
    leaf of a single-leaf tree), and the triangle records to the tables."""
    scene = SCENES[name][1]()
    t = pack_trace_tables(scene)
    nodes = t.nodes.numpy()
    ints = nodes.view(np.int32)
    assert nodes.shape[1] == 32 and t.tris.shape == (scene.tri_v0.shape[0], 12)
    code, axis = ints[:, 24:28], ints[:, 28]
    # a leaf's code is the traversal stack's: -1 - (first slot << 4 | count)
    leaf = code < -1
    child = np.where(leaf, (-1 - code) >> 4, code)
    count = np.where(leaf, (-1 - code) & 15, 0)
    if scene.bvh.has_wide:
        q_min = np.stack([nodes[:, 0:4], nodes[:, 4:8], nodes[:, 8:12]], axis=2)
        q_max = np.stack([nodes[:, 12:16], nodes[:, 16:20], nodes[:, 20:24]], axis=2)
        assert np.array_equal(q_min, scene.bvh.q_min.numpy())
        assert np.array_equal(q_max, scene.bvh.q_max.numpy())
        assert np.array_equal(child, scene.bvh.q_child.numpy())
        assert np.array_equal(count, scene.bvh.q_leafc.numpy())
        assert np.array_equal(axis, scene.bvh.q_axis.numpy())
    else:
        assert child[0].tolist() == [0, -1, -1, -1]
        assert count[0].tolist() == [int(scene.bvh.tri_count[0]), 0, 0, 0]
    assert not ints[:, 29:32].any()
    assert 3 * t.depth + 1 <= t.stack and t.stack in STACK_SIZES
    tris = t.tris.numpy()
    assert np.array_equal(tris[:, 0:3], scene.tri_v0.numpy())
    assert np.array_equal(tris[:, 4:7], scene.tri_e1.numpy())
    assert np.array_equal(tris[:, 8:11], scene.tri_e2.numpy())
    assert np.array_equal(tris[:, 3].view(np.int32), scene.tri_mat.numpy())


def test_numpy_collapse4_matches_the_native_one():
    """models/bvh.py::collapse4 is the reference for the native BVH4 collapse."""
    from gpu_raytracer_tpu_torch.models.bvh import collapse4
    from gpu_raytracer_tpu_torch.models.bvh_native import collapse4_native

    b = make_courtyard_scene(2000, seed=1).bvh
    args = [x.numpy() for x in (b.left, b.right, b.tri_start, b.tri_count,
                                b.node_min, b.node_max)]
    for got, want in zip(collapse4(*args), collapse4_native(*args)):
        assert np.array_equal(got, want)


def test_stack_capacity_covers_the_bvh4_depth():
    """The traversal stack is sized from the tree on the host, and a tree
    too deep for every compiled stack is refused, not clamped."""
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import stack_capacity, wide_depth

    # a chain of internal nodes, each with one internal child and 3 leaves
    Q = 10
    child = np.array([[q + 1, 0, 0, 0] for q in range(Q - 1)] + [[0, 0, 0, 0]], np.int32)
    leafc = np.array([[0, 1, 1, 1]] * (Q - 1) + [[1, 1, 1, 1]], np.int32)
    assert wide_depth(child, leafc) == Q
    assert [stack_capacity(d) for d in (1, 5, 6, 10, 21, 42)] == [16, 16, 32, 32, 64, 128]
    with pytest.raises(ValueError):
        stack_capacity(43)
