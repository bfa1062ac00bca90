"""Scene: plain dataclasses of tensors, built on the host and moved to one device.

Triangles are additionally expanded to Möller-Trumbore form (v0, e1, e2) in
BVH leaf order. The host build is NumPy and reproduces the JAX package's
`prepare_scene` bit for bit: the canonical corner rotation and triangle
order decide which triangle wins an exact-t tie, so both packages must
produce identical leaf tables.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..ops.texture import uv_density_code
from .bvh import Bvh, BvhBuildResult, align_leaves, build_bvh
from .camera import Camera
from .geometry import Mesh, Spheres, Textures, dedup_triangles
from .light import LightBuilder, Lights
from .material import MaterialBuilder, Materials


def to_device(obj, device):
    """Copy of a dataclass of tensors (nested dataclasses included) with
    every tensor on `device`."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = to_device(v, device)
        kw[f.name] = v
    return type(obj)(**kw)


@dataclass
class Scene:
    camera: Camera
    spheres: Spheres
    mesh: Mesh              # original triangle order, canonical corner rotation
    materials: Materials
    lights: Lights
    textures: Textures
    bvh: Bvh
    # leaf-ordered, Möller-Trumbore-expanded triangles, padded with
    # degenerate (zero-edge) triangles that can never hit
    tri_v0: torch.Tensor    # [Tp,3] f32
    tri_e1: torch.Tensor    # [Tp,3] f32  (v1 - v0)
    tri_e2: torch.Tensor    # [Tp,3] f32  (v2 - v0)
    tri_mat: torch.Tensor   # [Tp] i32
    tri_uv: torch.Tensor    # [Tp,3,2] f32 per-corner texture coordinates
    tri_src: torch.Tensor   # [Tp] i32 original triangle id behind each slot (-1 pad)
    # [Tp] i32 per-slot 14-bit uv-density code (ops/texture.py), computed
    # once when the scene is built; the mip footprint of a hit decodes it
    tri_den: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.mesh.num_triangles

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def to(self, device) -> "Scene":
        return to_device(self, device)

    def with_camera(self, camera: Camera) -> "Scene":
        return dataclasses.replace(self, camera=camera.to(self.device))


def _expand_triangles(vertices, indices, material_id, uv, order, pad_to: int):
    """Gather + expand triangles into (v0, e1, e2, mat, uv, src) in `order`,
    padding with degenerate (zero-edge) triangles the intersector rejects."""
    v = np.asarray(vertices, np.float32)
    order = np.asarray(order, np.int64)
    pad_slot = order < 0
    safe = np.where(pad_slot, 0, order)
    idx = np.asarray(indices, np.int64)[safe]
    mat = np.asarray(material_id, np.int64)[safe]
    t = np.asarray(uv, np.float32)
    v0 = v[idx[:, 0]]
    e1 = v[idx[:, 1]] - v0
    e2 = v[idx[:, 2]] - v0
    tuv = t[idx]
    if pad_slot.any():
        z = pad_slot[:, None]
        v0 = np.where(z, 0.0, v0)
        e1 = np.where(z, 0.0, e1)
        e2 = np.where(z, 0.0, e2)
        mat = np.where(pad_slot, 0, mat)
        tuv = np.where(pad_slot[:, None, None], 0.0, tuv)
    T = v0.shape[0]
    Tp = max(((T + pad_to - 1) // pad_to) * pad_to, pad_to)
    src = np.where(pad_slot, -1, order)
    if Tp != T:
        pad = Tp - T
        z = np.zeros((pad, 3), np.float32)
        v0 = np.concatenate([v0, z])
        e1 = np.concatenate([e1, z])
        e2 = np.concatenate([e2, z])
        mat = np.concatenate([mat, np.zeros(pad, np.int64)])
        tuv = np.concatenate([tuv, np.zeros((pad, 3, 2), np.float32)])
        src = np.concatenate([src, np.full(pad, -1, np.int64)])
    return (v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32),
            mat.astype(np.int32), tuv.astype(np.float32), src)


def _corner_keys(vertices, indices, uv) -> np.ndarray:
    """[T,3,K] u32 per-corner content keys: zero-sign-normalised position
    bits then uv bits (`+ 0.0` folds -0.0 into +0.0)."""
    idx = np.asarray(indices, np.int64)
    p = np.ascontiguousarray(np.asarray(vertices, np.float32)[idx] + 0.0).view(np.uint32)
    parts = [p]
    uv = np.asarray(uv, np.float32)
    if uv.size:
        parts.append(np.ascontiguousarray(uv[idx] + 0.0).view(np.uint32))
    return np.concatenate(parts, axis=2)


def _canonical_corner_rotation(vertices, indices, uv) -> np.ndarray:
    """Rotate each index triple cyclically so its lexicographically smallest
    corner (by _corner_keys) leads. Winding, and so the normal e1 x e2, is
    kept; the expanded (v0, e1, e2) values depend on which corner leads."""
    idx = np.asarray(indices)
    T = idx.shape[0]
    key = _corner_keys(vertices, idx, uv)
    best = np.zeros(T, np.int64)
    ar = np.arange(T)
    for c in (1, 2):
        cur = key[ar, best]
        cand = key[:, c]
        lt = np.zeros(T, bool)
        decided = np.zeros(T, bool)
        for k in range(key.shape[2]):
            l = ~decided & (cand[:, k] < cur[:, k])
            g = ~decided & (cand[:, k] > cur[:, k])
            lt |= l
            decided |= l | g
        best = np.where(lt, c, best)
    return np.stack([idx[ar, (best + k) % 3] for k in range(3)], axis=1).astype(idx.dtype)


def _canonical_tri_order(vertices, indices, material_id, uv) -> np.ndarray:
    """Content-based triangle permutation: lexsort over the corner-key bit
    patterns and the material id, column 0 (v0.x bits) primary."""
    T = indices.shape[0]
    key = np.concatenate(
        [_corner_keys(vertices, indices, uv).reshape(T, -1),
         np.asarray(material_id, np.uint32).reshape(T, 1)], axis=1)
    # np.lexsort's LAST key is primary
    return np.lexsort(tuple(key[:, c] for c in range(key.shape[1] - 1, -1, -1)))


def _unit(v) -> np.ndarray:
    """Idempotent normalisation: vectors already unit at f32 pass through
    bit-unchanged, others normalise in f64."""
    v64 = np.asarray(v, np.float64)
    n = float(np.linalg.norm(v64))
    if n == 0.0 or abs(n - 1.0) <= 1e-6:
        return np.asarray(v, np.float32)
    return (v64 / n).astype(np.float32)


def prepare_scene(camera: Camera, spheres: Spheres, mesh: Mesh,
                  materials: Materials, lights: Lights,
                  textures: Textures | None = None,
                  config: RaytracerConfig = DEFAULT_CONFIG,
                  device="cpu") -> Scene:
    """Build the BVH on the host, reorder triangles into leaf order,
    precompute edges, and move the scene to `device`."""
    if config.bvh_spatial_splits:
        raise NotImplementedError("the spatial-split (SBVH) builder is not ported yet")

    camera = dataclasses.replace(
        camera, direction=torch.from_numpy(_unit(camera.direction.numpy())),
        up=torch.from_numpy(_unit(camera.up.numpy())))
    ld = lights.direction.numpy().astype(np.float64)
    nrm = np.linalg.norm(ld, axis=1, keepdims=True)
    unit_rows = np.abs(nrm - 1.0) <= 1e-6
    scale = np.where((nrm == 0.0) | unit_rows, 1.0, nrm)
    lights = dataclasses.replace(
        lights, direction=torch.from_numpy((ld / scale).astype(np.float32)))

    vertices = np.asarray(mesh.vertices)
    indices = np.asarray(mesh.indices)
    material_id = np.asarray(mesh.material_id)
    muv = np.asarray(mesh.uv)
    canon = None
    if indices.shape[0] > 1:
        # canonical triangle form: smallest corner leads (kept in the
        # mesh), then the build sequence sorted by content
        indices = _canonical_corner_rotation(vertices, indices, muv)
        mesh = dataclasses.replace(mesh, indices=indices)
        canon = _canonical_tri_order(vertices, indices, material_id, muv)
        indices = indices[canon]
        material_id = material_id[canon]
    # 8-slot leaf rows; 12 for very large or wide-leaf untextured scenes,
    # as the JAX package packs (its 12-slot rows carry no uvs)
    textured = textures is not None and textures.textured
    big = indices.shape[0] > 1_200_000
    align = 12 if ((big or config.bvh_leaf_size > 8) and not textured) else 8
    bvh_result = align_leaves(build_bvh(vertices, indices, leaf_size=align), align)
    v0, e1, e2, mat, tuv, src = _expand_triangles(
        vertices, indices, material_id, muv, bvh_result.tri_order,
        pad_to=max(config.bvh_leaf_size, bvh_result.leaf_align, 8))
    if canon is not None:
        # tri_src indexes the mesh's original order: compose with canon
        src = np.where(src >= 0, canon[np.maximum(src, 0)], -1)
    t = torch.from_numpy
    scene = Scene(camera=camera, spheres=spheres, mesh=mesh.to_tensors(),
                  materials=materials, lights=lights,
                  textures=textures if textures is not None else Textures.empty(),
                  bvh=bvh_result.to_tensors(width=config.bvh_width),
                  tri_v0=t(v0), tri_e1=t(e1), tri_e2=t(e2), tri_mat=t(mat),
                  tri_uv=t(tuv), tri_src=t(src.astype(np.int32)),
                  tri_den=uv_density_code(t(e1), t(e2), t(tuv)))
    return scene.to(device)


def build_default_scene(config: RaytracerConfig = DEFAULT_CONFIG,
                        device="cpu") -> Scene:
    """The demo scene: 4 materials, 6 spheres, 2 triangles, 1 point light,
    default camera."""
    mats = MaterialBuilder()
    mats.add_diffuse((0.8, 0.3, 0.3))                    # 0: red diffuse
    mats.add_metallic((0.8, 0.8, 0.2), 0.1)              # 1: yellow metal
    mats.add_glass((0.2, 0.3, 0.8), 1.5, 0.9)            # 2: blue glass
    mats.add_emissive((1.0, 1.0, 1.0), (0.5, 0.5, 1.0))  # 3: blue light

    spheres = Spheres.from_rows([
        ((0.0, 0.0, -1.0), 0.5, 0),
        ((-1.0, 0.0, -1.0), 0.5, 1),
        ((1.0, 0.0, -1.0), 0.5, 2),
        ((2.0, 0.0, -3.0), 0.5, 2),
        ((-2.0, 0.0, -4.0), 0.5, 1),
        ((-1.0, 2.0, -5.0), 0.5, 3),
    ])
    tri_verts = np.asarray([
        [[0.0, 1.0, -2.0], [-0.5, 0.0, -2.0], [0.5, 0.0, -2.0]],
        [[1.5, 0.5, -3.0], [1.0, -0.5, -3.0], [2.0, -0.5, -3.0]],
    ], np.float32)
    v, i, m = dedup_triangles(tri_verts, np.asarray([0, 1], np.uint32))
    mesh = Mesh.from_arrays(v, i, m)

    lb = LightBuilder()
    lb.add_point((5.0, 7.0, 4.0), (1.0, 1.0, 1.0), 1.0, float("inf"))
    return prepare_scene(Camera.default(), spheres, mesh, mats.build(),
                         lb.build(), config=config, device=device)
