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
from ..ops.lbvh import GROUP, build_lbvh_grouped_arrays, collapse4_device
from ..ops.texture import uv_density_code
from .bvh import Bvh, BvhBuildResult, align_leaves, build_bvh, build_bvh_spatial
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
    """Build the BVH on the host (binned SAH, or with
    `config.bvh_spatial_splits` the spatial-split builder; its wide overlay
    `config.bvh_width` children across), reorder triangles into leaf order,
    precompute edges, and move the scene to `device`."""

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
    build = build_bvh_spatial if config.bvh_spatial_splits else build_bvh
    bvh_result = align_leaves(build(vertices, indices, leaf_size=align), align)
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


LBVH_DEPTH = 128   # Bvh.depth a rebuilt tree declares (no measured depth on the device)


def upload(a, device) -> torch.Tensor:
    """A host array (or tensor) on `device`. Bound for a CUDA device from the
    host it goes through a pinned staging copy, non-blocking: a pageable
    copy would make the host wait for the card. A NumPy array is copied,
    never aliased."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=t is not a)


def _refit_core(vertices, indices, material_id, uv):
    """The full rebuild over the minimal inputs (vertex positions and the
    mesh's static topology): grouped LBVH with 8-slot leaves, the even-depth
    BVH4 overlay, and the triangle tables in the new leaf order, padded to
    8 * ceil(T/8) with degenerate slots (tri_src -1)."""
    a, b, c = vertices[indices[:, 0]], vertices[indices[:, 1]], vertices[indices[:, 2]]
    tri_min = torch.minimum(a, torch.minimum(b, c))
    tri_max = torch.maximum(a, torch.maximum(b, c))
    (nmin, nmax, left, right, tri_start, tri_count, hit, miss,
     order) = build_lbvh_grouped_arrays(tri_min, tri_max)
    quad = (collapse4_device(nmin, nmax, left, right, tri_start, tri_count)
            if left.shape[0] > 1 else None)
    o = order.long()
    v0 = a[o]
    e1 = b[o] - v0
    e2 = c[o] - v0
    mat = material_id.to(torch.int32)[o]
    tuv = uv[indices][o]                        # [T,3,2]
    srcs = order
    pad = (-v0.shape[0]) % GROUP
    if pad:
        z = v0.new_zeros((pad, 3))
        v0, e1, e2 = torch.cat([v0, z]), torch.cat([e1, z]), torch.cat([e2, z])
        mat = torch.cat([mat, mat.new_zeros((pad,))])
        tuv = torch.cat([tuv, tuv.new_zeros((pad, 3, 2))])
        srcs = torch.cat([srcs, srcs.new_full((pad,), -1)])
    return (nmin, nmax, left, right, tri_start, tri_count, hit, miss,
            v0, e1, e2, mat, tuv, srcs, quad)


def _refit_topology_core(vertices, indices, tri_src, bvh: Bvh):
    """Topology-keeping refit: the tree (links, leaf ranges, quad children)
    stays; the triangles are re-expanded from the moved vertices and the
    boxes swept bottom-up again, the quad overlay's through q_src. No shape
    changes, and the tree's tensors are the same objects."""
    Tp = tri_src.shape[0]
    dev = vertices.device
    valid = (tri_src >= 0)[:, None]
    idx = indices[torch.clamp(tri_src.long(), 0, indices.shape[0] - 1)]
    a, b, c = vertices[idx[:, 0]], vertices[idx[:, 1]], vertices[idx[:, 2]]
    zero = torch.zeros((), dtype=vertices.dtype, device=dev)
    big = torch.full((), 3.0e38, dtype=vertices.dtype, device=dev)
    v0 = torch.where(valid, a, zero)
    e1 = torch.where(valid, b - a, zero)     # zero edges: det 0, never a hit
    e2 = torch.where(valid, c - a, zero)
    tmin = torch.where(valid, torch.minimum(a, torch.minimum(b, c)), big)
    tmax = torch.where(valid, torch.maximum(a, torch.maximum(b, c)), -big)

    leaf = (bvh.left < 0)[:, None]
    N = bvh.left.shape[0]
    nm = torch.full((N, 3), 3.0e38, dtype=vertices.dtype, device=dev)
    nx = torch.full((N, 3), -3.0e38, dtype=vertices.dtype, device=dev)
    start, count = bvh.tri_start.long(), bvh.tri_count.long()
    for j in range(bvh.max_leaf):   # leaf boxes, one slot at a time
        ok = (j < count)[:, None] & leaf
        sidx = torch.clamp(start + j, 0, Tp - 1)
        nm = torch.where(ok, torch.minimum(nm, tmin[sidx]), nm)
        nx = torch.where(ok, torch.maximum(nx, tmax[sidx]), nx)
    lc = torch.clamp(bvh.left.long(), 0, N - 1)
    rc = torch.clamp(bvh.right.long(), 0, N - 1)
    # bvh.depth sweeps of child gathers, the reference's fixed count: no
    # convergence test, which would read the device
    for _ in range(bvh.depth):
        nm = torch.where(leaf, nm, torch.minimum(nm[lc], nm[rc]))
        nx = torch.where(leaf, nx, torch.maximum(nx[lc], nx[rc]))
    kw = {}
    if bvh.q_src is not None:
        okq = (bvh.q_src >= 0)[..., None]
        qs = torch.clamp(bvh.q_src.long(), 0, N - 1)
        far = torch.full((), 1e30, dtype=vertices.dtype, device=dev)
        kw = dict(q_min=torch.where(okq, nm[qs], far), q_max=torch.where(okq, nx[qs], far))
    return dataclasses.replace(bvh, node_min=nm, node_max=nx, **kw), v0, e1, e2


def refit_scene(scene: Scene, vertices, rebuild: bool = False) -> Scene:
    """The scene with its mesh moved to `vertices` [V,3] (same topology),
    its BVH and triangle tables updated on the scene's device: no host round
    trip (host vertices go up in one pinned, non-blocking copy).

    * topology refit (default): keep the tree, re-expand the triangles and
      sweep the boxes again (`_refit_topology_core`); every shape stays.
    * full rebuild (`rebuild=True`): Morton codes, sort, Karras hierarchy
      over aligned 8-slot leaf groups and the even-depth BVH4 overlay
      (ops/lbvh.py), for large deformations where a kept tree degrades. The
      BVH declares depth LBVH_DEPTH.

    Both recompute the per-slot uv-density code (`tri_den`) from the moved
    triangles: a non-rigid move changes every triangle's texel density."""
    vertices = upload(vertices, scene.device).to(torch.float32)
    mesh = dataclasses.replace(scene.mesh, vertices=vertices)
    indices = scene.mesh.indices.long()
    if not rebuild:
        bvh, v0, e1, e2 = _refit_topology_core(vertices, indices, scene.tri_src, scene.bvh)
        return dataclasses.replace(scene, mesh=mesh, bvh=bvh, tri_v0=v0, tri_e1=e1, tri_e2=e2,
                                   tri_den=uv_density_code(e1, e2, scene.tri_uv))
    (nmin, nmax, left, right, tri_start, tri_count, hit, miss,
     v0, e1, e2, mat, tuv, srcs, quad) = _refit_core(vertices, indices, scene.mesh.material_id,
                                                    scene.mesh.uv)
    qkw = {}
    if quad is not None:
        qkw = dict(zip(("q_child", "q_leafc", "q_min", "q_max", "q_axis", "q_src"), quad))
    bvh = Bvh(node_min=nmin, node_max=nmax, left=left, right=right, tri_start=tri_start,
              tri_count=tri_count, hit_link=hit, miss_link=miss, leaf_align=GROUP,
              max_leaf=GROUP, depth=LBVH_DEPTH, **qkw)
    return dataclasses.replace(scene, mesh=mesh, bvh=bvh, tri_v0=v0, tri_e1=e1, tri_e2=e2,
                               tri_mat=mat, tri_uv=tuv, tri_src=srcs,
                               tri_den=uv_density_code(e1, e2, tuv))


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


def memory_stats(scene: Scene) -> dict:
    """Bytes of each part of the scene as it is held (tensor nbytes; nothing
    is read from the device), with the triangle, vertex and node counts."""
    def nbytes(obj) -> int:
        if isinstance(obj, torch.Tensor):
            return obj.nbytes
        if isinstance(obj, np.ndarray):
            return obj.nbytes
        if dataclasses.is_dataclass(obj):
            return sum(nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
        return 0

    tris = scene.mesh.num_triangles
    verts = scene.mesh.num_vertices
    stats = {
        "spheres_bytes": nbytes(scene.spheres),
        "mesh_bytes": nbytes(scene.mesh),
        "expanded_tri_bytes": scene.tri_v0.nbytes * 3 + scene.tri_mat.nbytes,
        "materials_bytes": nbytes(scene.materials),
        "lights_bytes": nbytes(scene.lights),
        "textures_bytes": nbytes(scene.textures),
        "bvh_bytes": nbytes(scene.bvh),
        "triangles": tris,
        "vertices": verts,
        "bvh_nodes": scene.bvh.num_nodes,
    }
    stats["total_bytes"] = sum(v for k, v in stats.items() if k.endswith("_bytes"))
    # what sharing vertices saves against three corners stored per triangle
    stats["dedup_savings_bytes"] = max(tris * 9 * 4 - verts * 12, 0)
    return stats


def print_memory_usage(scene: Scene) -> None:
    s = memory_stats(scene)

    def mb(b):
        if b < 1024 * 1024:
            return f"{b / 1024:8.2f} KB"
        return f"{b / (1024 * 1024):8.2f} MB"
    print("=== Scene memory usage ===")
    for key in ("spheres_bytes", "mesh_bytes", "expanded_tri_bytes",
                "materials_bytes", "lights_bytes", "textures_bytes", "bvh_bytes"):
        print(f"  {key[:-6]:>14}: {mb(s[key])}")
    print(f"  {'total':>14}: {mb(s['total_bytes'])}")
    print(f"  triangles={s['triangles']} vertices={s['vertices']} "
          f"bvh_nodes={s['bvh_nodes']} dedup_savings={mb(s['dedup_savings_bytes'])}")
