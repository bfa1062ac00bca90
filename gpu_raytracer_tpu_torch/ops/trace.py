"""Closest-hit / any-hit tracing over a whole scene: the plain version.

Spheres are tested exhaustively, triangles through the BVH (or brute force
for a single-leaf tree), and the winner is picked with the reference's tie
rule: the sphere pass runs first with closest_t seeded to f32::MAX - 2, the
triangle pass is pruned at the sphere's t with strict `<`, so at equal t the
sphere wins.

`traverse_triangles` is the plain version of the CUDA traversal kernel
(ops/cuda/traverse.py): same inputs, same (t, slot, hit, normal, material)
result, in the reference's left-first order.

In a textured scene a hit also carries its texture coordinates: the
winner triangle's corner uvs interpolated with its Möller-Trumbore
barycentrics (recomputed once for the winner), or a sphere's
equirectangular uv.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.scene import Scene
from .bvh_traverse import bvh_traverse_threaded
from .intersect import MISS_T, closest_select, sphere_intersect, triangle_hit_pairwise
from .linalg import cross, dot, normalize
from .texture import interpolate_uv, sphere_uv

SPHERE, TRIANGLE = 0, 1
_BRUTE_BLOCK = 512  # triangles per brute-force block (bounds the [N,K] tile)


@dataclass
class Hit:
    t: torch.Tensor            # [N] f32, MISS_T on a miss
    hit: torch.Tensor          # [N] bool
    prim_kind: torch.Tensor    # [N] i64: 0 sphere, 1 triangle, -1 miss
    prim_id: torch.Tensor      # [N] i64: sphere index / leaf-order triangle slot
    point: torch.Tensor        # [N,3] f32
    normal: torch.Tensor       # [N,3] f32
    material_id: torch.Tensor  # [N] i64, -1 on a miss
    uv: torch.Tensor           # [N,2] f32, 0 on a miss and in untextured scenes


def mt_bary(orig, dirn, v0, e1, e2):
    """Möller-Trumbore barycentrics (u, v), the weights of corners 1 and 2,
    of known-hit triangles, one per ray (all [N,3])."""
    h = cross(dirn, e2)
    a = dot(e1, h)
    f = 1.0 / torch.where(a == 0.0, torch.ones_like(a), a)
    s = orig - v0
    q = cross(s, e1)
    return f * dot(s, h), f * dot(dirn, q)


def _triangles_brute(scene: Scene, orig, dirn, max_t, any_hit: bool):
    """Every ray against every triangle, in blocks; the first-occurring
    minimum wins, as in a sequential strict-< loop."""
    N = orig.shape[0]
    Tp = scene.tri_v0.shape[0]
    best_t = max_t.clone()
    best_i = torch.full((N,), -1, dtype=torch.int64, device=orig.device)
    for s in range(0, Tp, _BRUTE_BLOCK):
        e = min(s + _BRUTE_BLOCK, Tp)
        K = e - s
        t, hit = triangle_hit_pairwise(
            orig[:, None, :], dirn[:, None, :], scene.tri_v0[None, s:e],
            scene.tri_e1[None, s:e], scene.tri_e2[None, s:e],
            max_t[:, None].expand(N, K))
        t_blk, i_blk, any_blk = closest_select(t, hit)
        win = any_blk & (t_blk < best_t)
        if any_hit:
            win &= best_i < 0
        best_t = torch.where(win, t_blk, best_t)
        best_i = torch.where(win, s + i_blk, best_i)
    hit = best_i >= 0
    return torch.where(hit, best_t, torch.full_like(best_t, MISS_T)), best_i, hit


def traverse_triangles(scene: Scene, orig, dirn, max_t, any_hit: bool = False):
    """Triangle closest hit (or any hit) for rays orig/dirn [N,3] below
    max_t [N] -> (t [N] MISS_T on a miss, slot [N] i64 or -1, hit [N],
    unit geometric normal [N,3] (0 on a miss), material [N] i64 (-1))."""
    if scene.bvh.num_nodes > 1:
        t, slot, hit = bvh_traverse_threaded(
            scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2, orig, dirn,
            max_t, leaf_size=scene.bvh.max_leaf, any_hit=any_hit)
    else:
        t, slot, hit = _triangles_brute(scene, orig, dirn, max_t, any_hit)
    return (t, slot, hit) + slot_attributes(scene, slot, hit)


def slot_attributes(scene: Scene, slot, hit):
    """The winning slots' unit geometric normal [N,3] (0 on a miss) and
    material [N] i64 (-1 on a miss)."""
    ti = torch.clamp(slot, min=0)
    normal = normalize(cross(scene.tri_e1[ti], scene.tri_e2[ti]))
    normal = torch.where(hit[:, None], normal, torch.zeros_like(normal))
    mat = torch.where(hit, scene.tri_mat[ti].long(), torch.full_like(slot, -1))
    return normal, mat


def _max_t(max_t, orig: torch.Tensor) -> torch.Tensor:
    """[N] limits in the rays' dtype (float32, or float64 in precision checks)."""
    if max_t is None:
        max_t = MISS_T - 2.0   # f32::MAX - 2 seed, which is f32::MAX in f32
    n = orig.shape[0]
    if isinstance(max_t, torch.Tensor):
        return max_t.to(orig.device, orig.dtype).expand(n).contiguous()
    return torch.full((n,), max_t, dtype=orig.dtype, device=orig.device)


def trace(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor, max_t=None,
          triangles=traverse_triangles) -> Hit:
    """Closest hit for a ray batch orig/dirn [N,3]. `triangles` is the
    triangle pass, called as triangles(scene, orig, dirn, limit) with the
    result of `traverse_triangles`: the plain walk, or the CUDA traversal
    kernel (ops/cuda/traverse.py::trace)."""
    max_t = _max_t(max_t, orig)
    sph = scene.spheres
    s_t, s_hit = sphere_intersect(orig, dirn, sph.center, sph.radius, max_t)
    sph_t, sph_i, sph_any = closest_select(s_t, s_hit)
    tri_limit = torch.where(sph_any, sph_t, max_t)  # strict < keeps the sphere on a tie

    tri_t, tri_i, use_tri, tri_normal, tri_m = triangles(scene, orig, dirn, tri_limit)

    t = torch.where(use_tri, tri_t, torch.where(sph_any, sph_t, torch.full_like(sph_t, MISS_T)))
    hit = use_tri | sph_any
    point = orig + dirn * t[:, None]
    si = torch.clamp(sph_i, max=sph.count - 1)
    sphere_normal = normalize(point - sph.center[si])
    normal = torch.where(use_tri[:, None], tri_normal, sphere_normal)
    zeros3 = torch.zeros_like(normal)
    minus1 = torch.full_like(tri_i, -1)
    material_id = torch.where(use_tri, tri_m, sph.material_id[si])
    uv = torch.zeros((orig.shape[0], 2), dtype=orig.dtype, device=orig.device)
    if scene.textures.textured:
        ti = torch.clamp(tri_i, min=0)
        bu, bv = mt_bary(orig, dirn, scene.tri_v0[ti], scene.tri_e1[ti], scene.tri_e2[ti])
        tri_uv = interpolate_uv(scene.tri_uv, ti, bu, bv)
        uv = torch.where(use_tri[:, None], tri_uv, sphere_uv(sphere_normal))
        uv = torch.where(hit[:, None], uv, torch.zeros_like(uv))
    return Hit(
        t=torch.where(hit, t, torch.full_like(t, MISS_T)),
        hit=hit,
        prim_kind=torch.where(hit, torch.where(use_tri, TRIANGLE, SPHERE), minus1),
        prim_id=torch.where(hit, torch.where(use_tri, tri_i, sph_i), minus1),
        point=torch.where(hit[:, None], point, zeros3),
        normal=torch.where(hit[:, None], normal, zeros3),
        material_id=torch.where(hit, material_id, minus1),
        uv=uv,
    )


def occluded(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor,
             max_t: torch.Tensor) -> torch.Tensor:
    """Any-hit query for shadow rays: True where something blocks (MIN_T, max_t)."""
    max_t = _max_t(max_t, orig)
    sph = scene.spheres
    _, s_hit = sphere_intersect(orig, dirn, sph.center, sph.radius, max_t)
    tri_block = traverse_triangles(scene, orig, dirn, max_t, any_hit=True)[2]
    return s_hit.any(dim=-1) | tri_block
