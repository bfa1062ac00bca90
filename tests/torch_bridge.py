"""Helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Importing this module caps PyTorch's intra-op threads: the suite runs under
pytest-xdist with several workers, and the JAX package's tests share the
cores. It also turns the port's texture disk cache off (an empty
GPU_RAYTRACER_TPU_TORCH_CACHE, unless one is set), so every atlas a test
compares is built; tests/test_torch_procgen_cache.py points it at a
temporary directory. Only tests import both packages; the port itself never
imports JAX.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gpu_raytracer_tpu_torch.bridge import GROUPS, TOP_LEVEL, scene_from_arrays, scene_to_arrays

torch.set_num_threads(2)
os.environ.setdefault("GPU_RAYTRACER_TPU_TORCH_CACHE", "")

__all__ = ["jax_scene_arrays", "port_scene_from_jax", "scene_to_arrays",
           "assert_arrays_equal", "canonical_binary_tree", "f16_attenuation_flips",
           "rounding_sensitive_pixels", "mip_flip_pixels"]


def jax_scene_arrays(scene) -> dict:
    """np.asarray over every field of a JAX `Scene`, under the keys of
    gpu_raytracer_tpu_torch.bridge (metadata fields stay Python values)."""
    out = {}
    for name in GROUPS:
        obj = getattr(scene, name)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f"{name}.{f.name}"] = (v if v is None or isinstance(v, (bool, int, tuple))
                                       else np.asarray(v))
    for k in TOP_LEVEL:
        out[k] = np.asarray(getattr(scene, k))
    return out


def port_scene_from_jax(scene, device="cpu"):
    """The port's Scene carrying the JAX scene's tables."""
    return scene_from_arrays(jax_scene_arrays(scene), device)


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return np.ascontiguousarray(a, np.float32).view(np.uint32)
    return a.astype(np.int64)


def assert_arrays_equal(a: dict, b: dict, skip=()) -> None:
    """Field-by-field equality: floats bit for bit, integers by value (the
    port keeps unsigned 32-bit columns as int64), metadata by value."""
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    bad = []
    for k in sorted(a):
        if k in skip:
            continue
        x, y = a[k], b[k]
        if x is None or y is None or isinstance(x, (bool, int, tuple)):
            ok = (x == y) if not isinstance(x, tuple) else tuple(x) == tuple(y)
        else:
            x, y = np.asarray(x), np.asarray(y)
            ok = x.shape == y.shape and np.array_equal(_bits(x), _bits(y))
        if not ok:
            bad.append(k)
    assert not bad, f"fields differ: {bad}"


_LINKS = ("bvh.left", "bvh.right", "bvh.hit_link", "bvh.miss_link")
_PER_NODE = ("bvh.node_min", "bvh.node_max", "bvh.tri_start", "bvh.tri_count")


def canonical_binary_tree(arrays: dict) -> dict:
    """Relabel the binary BVH's nodes in depth-first preorder (left child
    first). The native builder numbers nodes in the order its worker threads
    finish, which varies from run to run above 4096 triangles; the tree
    itself, and everything derived from it, does not."""
    left, right = arrays["bvh.left"], arrays["bvh.right"]
    order, stack = [], [0]
    while stack:
        x = stack.pop()
        order.append(x)
        if left[x] >= 0:
            stack += [int(right[x]), int(left[x])]
    order = np.asarray(order)
    inv = np.empty(left.shape[0], np.int64)
    inv[order] = np.arange(order.shape[0])
    relabel = lambda ids: np.where(ids >= 0, inv[np.maximum(ids, 0)], -1)
    out = dict(arrays)
    for k in _PER_NODE:
        out[k] = np.asarray(arrays[k])[order]
    for k in _LINKS:
        out[k] = relabel(np.asarray(arrays[k])[order])
    if arrays.get("bvh.q_src") is not None:
        out["bvh.q_src"] = relabel(np.asarray(arrays["bvh.q_src"]))
    return out


def f16_attenuation_flips(scene, hit) -> np.ndarray:
    """[N] bool: rays whose f16-rounded point-light attenuation depends on
    whether `1 + 0.01 d^2` is evaluated with a fused multiply-add. XLA:CPU
    contracts it into one FMA, the port (like the TPU kernel and the CUDA
    kernel built with -fmad=false) rounds the product first; the two f32
    values differ by an ulp, which moves the f16 rounding only where the
    value sits on an f16 rounding boundary."""
    p = hit.point.numpy().astype(np.float32)
    L = scene.lights
    flips = np.zeros(p.shape[0], bool)
    c = np.float32(0.01)
    for li in range(L.count):
        tl = (L.position[li].numpy()[None, :] - p).astype(np.float32)
        d2 = ((tl[:, 0] * tl[:, 0] + tl[:, 1] * tl[:, 1]) + tl[:, 2] * tl[:, 2]).astype(np.float32)
        dd = (np.sqrt(d2) * np.sqrt(d2)).astype(np.float32)
        plain = (np.float32(1) / ((dd * c).astype(np.float32) + np.float32(1))).astype(np.float32)
        fused = (np.float32(1) / (dd.astype(np.float64) * np.float64(c) + 1.0).astype(np.float32))
        flips |= plain.astype(np.float16) != fused.astype(np.float32).astype(np.float16)
    return flips & hit.hit.numpy()


def _as_float64(obj):
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
            v = v.double()
        elif dataclasses.is_dataclass(v):
            v = _as_float64(v)
        kw[f.name] = v
    return type(obj)(**kw)


def rounding_sensitive_pixels(scene, width, height, shadows=False, sky=(0.0, 0.0, 0.0),
                              tol=1e-6, trilinear=False) -> np.ndarray:
    """[H,W] bool: pixels where single-precision rounding alone moves the
    plain render by more than `tol` from the same pipeline evaluated in
    float64 (sphere silhouettes, where b^2 - 4ac cancels, grazing hits).
    There another f32 evaluation order, such as XLA:CPU's fused
    multiply-adds, can land further than the 1e-5 parity tolerance away."""
    from gpu_raytracer_tpu_torch.ops.render import render_chunk

    py, px = torch.meshgrid(torch.arange(height, dtype=torch.int32),
                            torch.arange(width, dtype=torch.int32), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    f32 = render_chunk(scene, px, py, width, height, shadows=shadows, sky=sky,
                       trilinear=trilinear)
    f64 = render_chunk(_as_float64(scene), px, py, width, height, shadows=shadows, sky=sky,
                       trilinear=trilinear)
    dev = (f32.double() - f64).abs().amax(dim=1)
    return (dev > tol).numpy().reshape(height, width)


def mip_flip_pixels(scene, hit, height, rel=1e-6) -> np.ndarray:
    """[N] bool: textured hits whose nearest mip level of some sampled map
    sits within `rel` of a level boundary, judged in float64: there
    lam * w * sqrt(2) is so close to a power of two that a one-ulp change
    of the hit distance (another f32 evaluation order of the traversal)
    picks the neighbouring level."""
    from gpu_raytracer_tpu_torch.ops.shading import hit_footprint

    if scene.textures.n_levels <= 1:
        return np.zeros(hit.t.shape[0], bool)
    lam = hit_footprint(scene, hit, height).double()
    m = scene.materials
    mid = torch.clamp(hit.material_id, 0, m.count - 1)
    tex = scene.textures
    flips = torch.zeros_like(hit.hit)
    for slot in m.present_slots:
        ti = m.texture_indices[mid, slot]
        valid = ti != 0xFFFFFFFF
        w = tex.width[torch.clamp(torch.where(valid, ti, 0), max=tex.count - 1)].double()
        x = lam * w * np.sqrt(2.0)
        lo = torch.floor(torch.log2(x * (1.0 - rel)))
        hi = torch.floor(torch.log2(x * (1.0 + rel)))
        flips |= valid & (x > 0) & (lo != hi)
    return (flips & hit.hit).numpy()
