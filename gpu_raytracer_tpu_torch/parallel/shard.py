"""Multi-device rendering over a `parallel/mesh.py::Mesh`.

The JAX package's `parallel/shard.py` in PyTorch, one process driving
every shard (as `shard_map` does), its collectives the plain functions of
mesh.py. The three strategies:

* **Ray sharding** (`render_rays_sharded`, `render_frame_multichip`,
  `render_frame_fused_multichip`, `pathtrace_step_sharded`): the pixel
  batch is split over the shards, the scene's tables replicated; each shard
  renders its block with the kernels of one device (K1 below the plain
  shading; K2, or K3 + K4 when textured; K6 five times a sample), and the
  blocks are gathered. The step's per-depth counts are summed.
* **Geometry sharding** (`GeometryShards`, `trace_geometry_sharded`): the
  triangles are Morton-partitioned into spatially compact chunks, each with
  its own BVH and K1 tables on its shard's device; every shard walks the
  full ray batch with K1, and the closest hit is combined by reduction:
  pmin(t), pmin(original id among the t-winners: the lower id wins a tie),
  then a masked sum of the one winner's normal, uv and material.
* **Ring** (`trace_geometry_sharded_ring`): rays and triangles both
  sharded: D blocks of rays visit the D sub-BVHs by moving one shard along
  the ring per step, with their running winner, whose t is K1's per-ray
  max_t, so a ray that already hit culls later sub-BVHs at the root. An
  equal t in a later shard does not replace the winner (K1's test is
  strict), so cross-shard ties go to the earlier-visited shard.

What JAX re-jits on every call is built once here and handed in: the mesh,
`GeometryShards` (one `TraceTables` per shard) and the replicated tables
(`replicate_tables`). The device picks each kernel's route (CUDA tensors
launch the kernels, CPU tensors take their plain versions); JAX's
`use_pallas` / `packet_size` / `interpret` have no counterpart. A shard
that is not on the card never launches a kernel, and on the card none of
these paths takes a plain version. The shards' own tables are not padded
to a common shape: that was `shard_map`'s need.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..engine.pathtracer import _sample_chunk
from ..engine.renderer import WARP_BLOCK, light_seed, tiled_pixel_order
from ..models.bvh import align_leaves, build_bvh
from ..models.scene import Scene, _expand_triangles
from ..ops.camera_rays import generate_rays
from ..ops.cuda.render import pack_render_tables, render_deferred, render_primary
from ..ops.cuda.texshade import texture_shade
from ..ops.cuda.traverse import TraceTables, pack_trace_tables, traverse
from ..ops.cuda.traverse import trace as k1_trace
from ..ops.intersect import MISS_T, closest_select, sphere_intersect
from ..ops.linalg import normalize
from ..ops.shading import shade
from ..ops.texture import interpolate_uv, sphere_uv, uv_density_code
from ..ops.trace import SPHERE, TRIANGLE, Hit, mt_bary
from ..ops.wavefront import _sort_perm
from .mesh import Mesh, gather, pmin, ppermute_next, psum

INT_MAX = 2 ** 31 - 1
SHARD_LEAF = 8     # leaf size and leaf-row alignment of every sub-BVH, as JAX
MORTON_BITS = 10   # per axis, of the centroid partition


def replicate_tables(mesh: Mesh, scene: Scene, pack=pack_render_tables) -> list:
    """pack(scene on the device) once per distinct device of the mesh, one
    entry per shard: `pack_render_tables` (the default), `pack_shade_tables`
    or `pack_bounce_tables`."""
    return mesh.on_devices(lambda dev: pack(scene.to(dev)))


def render_rays_sharded(tables: list, px: torch.Tensor, py: torch.Tensor, width: int,
                        height: int, mesh: Mesh, sky=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Trace + shade with the pixel batch split over the mesh: each shard's
    camera rays through K1 (`ops/cuda/traverse.py::trace`; the plain trace
    on the CPU) and the plain shading, no shadow rays -> RGB [N,3] on the
    mesh's first device. `tables`: per shard, `replicate_tables(mesh,
    scene)`. N must divide by the mesh size (pad first)."""
    out = []
    for t, pxs, pys in zip(tables, mesh.split(px), mesh.split(py)):
        o, d = generate_rays(t.scene.camera, width, height, pxs, pys, fov_scale=t.fov_scale)
        out.append(shade(t.scene, k1_trace(t.trace, o, d), sky_color=sky))
    return gather(mesh, out)


def render_frame_multichip(tables: list, width: int, height: int, mesh: Mesh) -> np.ndarray:
    """The whole frame through `render_rays_sharded`, row-major, N padded to
    the mesh size with pixel (0, 0) -> host float32 [H,W,3]."""
    n = width * height
    pad = (-n) % mesh.size
    grid = torch.cat([torch.arange(n, dtype=torch.int64),
                      torch.zeros(pad, dtype=torch.int64)])
    dev = mesh.devices[0]
    px = (grid % width).to(torch.int32).to(dev)
    py = (grid // width).to(torch.int32).to(dev)
    rgb = render_rays_sharded(tables, px, py, width, height, mesh)
    return rgb[:n].reshape(height, width, 3).cpu().numpy()


# ---- geometry sharding ----

@dataclass
class Shard:
    """One sub-BVH: a Scene whose bvh and triangle arrays are the chunk's
    (leaf-ordered, 8-slot rows), the original mesh id behind each slot and
    the chunk's K1 tables, all on the shard's device."""
    scene: Scene
    orig_id: torch.Tensor   # [Tp] i32, INT_MAX on padding and in an inert shard
    tables: TraceTables


def morton_chunks(vertices: np.ndarray, indices: np.ndarray, n_shards: int) -> list:
    """Triangle ids split into n_shards contiguous runs of the Morton order
    of their centroids (10 bits an axis in the centroids' box), as JAX."""
    T = indices.shape[0]
    cent = (vertices[indices[:, 0]] + vertices[indices[:, 1]] + vertices[indices[:, 2]]) / 3.0
    lo, hi = cent.min(0), cent.max(0)
    q = np.clip(((cent - lo) / np.maximum(hi - lo, 1e-9) * 1024.0).astype(np.uint64), 0, 1023)
    code = np.zeros(T, np.uint64)
    for b in range(MORTON_BITS):
        for a in range(3):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + (2 - a))
    return np.array_split(np.argsort(code, kind="stable"), n_shards)


def _quad_root(bvh):
    """A single-node tree's one-record wide overlay, as JAX synthesises it:
    slot 0 is the leaf under the node's own box, slots 1-3 empty."""
    q_min = torch.full((1, 4, 3), 1e30)
    q_max = torch.full((1, 4, 3), 1e30)
    q_min[0, 0] = bvh.node_min[0]
    q_max[0, 0] = bvh.node_max[0]
    return dict(q_child=torch.tensor([[int(bvh.tri_start[0]), -1, -1, -1]], dtype=torch.int32),
                q_leafc=torch.tensor([[int(bvh.tri_count[0]), 0, 0, 0]], dtype=torch.int32),
                q_min=q_min, q_max=q_max, q_axis=torch.zeros((1,), dtype=torch.int32))


class GeometryShards:
    """Per-shard acceleration structures for geometry sharding, built on
    the host once per scene and mesh. The triangles are split into
    `mesh.size` spatially compact chunks (`morton_chunks`); each chunk gets
    its own SAH BVH with 8-slot leaf rows and its leaf-ordered triangle
    table, `shards[i]` on `mesh.devices[i]`. With more shards than
    triangles, an empty chunk becomes an INERT shard: one stand-in triangle
    with zero edges (never hit) and original id INT_MAX (never a winner),
    so no triangle is duplicated into the combine."""

    def __init__(self, scene: Scene, mesh: Mesh):
        m = scene.mesh
        host = lambda a: np.asarray(a.cpu().numpy() if torch.is_tensor(a) else a)
        verts = host(m.vertices).astype(np.float32)
        idx, mat_ids, uv = host(m.indices), host(m.material_id), host(m.uv)
        self.n_shards = mesh.size
        self.max_leaf = 1
        self.shards = []
        t = torch.from_numpy
        for chunk, dev in zip(morton_chunks(verts, idx, mesh.size), mesh.devices):
            chunk = np.asarray(chunk, np.int64)
            inert = chunk.size == 0
            if inert:
                chunk = np.asarray([0], np.int64)
            res = align_leaves(build_bvh(verts, idx[chunk], leaf_size=SHARD_LEAF), SHARD_LEAF)
            v0, e1, e2, mat, tuv, _ = _expand_triangles(verts, idx[chunk], mat_ids[chunk], uv,
                                                        res.tri_order, SHARD_LEAF)
            order = np.asarray(res.tri_order, np.int64)
            gid = np.where(order < 0, INT_MAX, chunk[np.where(order < 0, 0, order)])
            gid = np.concatenate([gid, np.full(v0.shape[0] - gid.shape[0], INT_MAX)])
            if inert:
                e1 = np.zeros_like(e1)
                e2 = np.zeros_like(e2)
                gid = np.full_like(gid, INT_MAX)
            bvh = res.to_tensors(width=4)
            if not bvh.has_wide:
                bvh = dataclasses.replace(bvh, **_quad_root(bvh))
            self.max_leaf = max(self.max_leaf, bvh.max_leaf)
            src = np.where(gid == INT_MAX, -1, gid).astype(np.int32)
            sub = dataclasses.replace(scene, bvh=bvh, tri_v0=t(v0), tri_e1=t(e1), tri_e2=t(e2),
                                      tri_mat=t(mat), tri_uv=t(tuv), tri_src=t(src),
                                      tri_den=uv_density_code(t(e1), t(e2), t(tuv))).to(dev)
            self.shards.append(Shard(sub, t(gid.astype(np.int32)).to(dev),
                                     pack_trace_tables(sub)))


def _shard_hits(shard: Shard, o, d, max_t):
    """K1 over one sub-BVH -> (t, original id (INT_MAX on a miss), hit,
    normal, material, uv): the uv of the winner slot's barycentrics, as the
    JAX kernel interpolates it."""
    t, slot, hit, normal, mat = traverse(shard.tables, o, d, max_t)
    sc = shard.scene
    ti = torch.clamp(slot.long(), min=0)
    bu, bv = mt_bary(o, d, sc.tri_v0[ti], sc.tri_e1[ti], sc.tri_e2[ti])
    uv = torch.where(hit[:, None], interpolate_uv(sc.tri_uv, ti, bu, bv), torch.zeros_like(o[:, :2]))
    g = torch.where(hit, shard.orig_id[ti], torch.full_like(shard.orig_id[ti], INT_MAX))
    return t, g, hit, normal, mat.to(torch.int32), uv


def _merge_spheres(scene: Scene, orig, dirn, tri_t, tri_g, tri_n, tri_m, tri_uv,
                   tri_hit) -> Hit:
    """The sphere pass (replicated, tiny) merged with the sharded triangle
    winner -> Hit, the winner's prim_id its original mesh id; at equal t the
    sphere wins, as in the single-device trace."""
    sph = scene.spheres
    far = torch.full((orig.shape[0],), MISS_T - 2.0, dtype=orig.dtype, device=orig.device)
    s_t, s_hit = sphere_intersect(orig, dirn, sph.center, sph.radius, far)
    sph_t, sph_i, sph_any = closest_select(s_t, s_hit)
    use_tri = tri_hit & (~sph_any | (tri_t < sph_t))
    miss = torch.full_like(tri_t, MISS_T)
    t = torch.where(use_tri, tri_t, torch.where(sph_any, sph_t, miss))
    hit = use_tri | sph_any
    point = orig + dirn * t[:, None]
    si = torch.clamp(sph_i, max=sph.count - 1)
    sphere_normal = normalize(point - sph.center[si])
    normal = torch.where(use_tri[:, None], tri_n, sphere_normal)
    mat = torch.where(use_tri, tri_m.long(), sph.material_id[si].long())
    uv = torch.where(use_tri[:, None], tri_uv, sphere_uv(sphere_normal))
    minus1 = torch.full_like(sph_i, -1)
    zeros3 = torch.zeros_like(normal)
    return Hit(t=torch.where(hit, t, miss), hit=hit,
               prim_kind=torch.where(hit, torch.where(use_tri, TRIANGLE, SPHERE), minus1),
               prim_id=torch.where(hit, torch.where(use_tri, tri_g.long(), sph_i), minus1),
               point=torch.where(hit[:, None], point, zeros3),
               normal=torch.where(hit[:, None], normal, zeros3),
               material_id=torch.where(hit, mat, minus1),
               uv=torch.where(hit[:, None], uv, torch.zeros_like(uv)))


def _sorted(fn, scene: Scene, orig, dirn, sort: bool) -> Hit:
    """fn(orig, dirn) on the rays in coherence order (the wavefront's key,
    ops/wavefront.py::_sort_perm), the Hit put back in the callers' order:
    per-ray results do not depend on it; blocks and warps get coherent."""
    if not sort:
        return fn(orig, dirn)
    perm = _sort_perm(scene, orig, dirn, torch.ones(orig.shape[0], dtype=torch.bool,
                                                     device=orig.device))
    inv = torch.argsort(perm)
    hit = fn(orig[perm].contiguous(), dirn[perm].contiguous())
    return Hit(**{f.name: getattr(hit, f.name)[inv] for f in dataclasses.fields(hit)})


def trace_geometry_sharded(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor, mesh: Mesh,
                           shards: GeometryShards, sort: bool = True) -> Hit:
    """Closest hit with the triangles sharded over the mesh: every shard
    walks the full ray batch through its sub-BVH with K1 (max_t f32::MAX),
    then the reduction combine (module docstring) and the sphere pass ->
    Hit on the mesh's first device, prim_id the original mesh id."""
    if shards.n_shards != mesh.size:
        raise ValueError(f"{shards.n_shards} geometry shards for a mesh of {mesh.size}")
    dev0 = mesh.devices[0]
    scene = scene.to(dev0)

    def combine(o, d):
        n = o.shape[0]
        per = []
        for shard, os_, ds_ in zip(shards.shards, mesh.replicate(o), mesh.replicate(d)):
            far = torch.full((n,), MISS_T - 2.0, dtype=torch.float32, device=os_.device)
            per.append(_shard_hits(shard, os_, ds_, far))
        tm = [torch.where(h, t, torch.full_like(t, MISS_T)) for t, _, h, _, _, _ in per]
        tmin = pmin(mesh, tm)
        on_t = [h & (x <= m) for (_, _, h, _, _, _), x, m in zip(per, tm, tmin)]
        gw = pmin(mesh, [torch.where(ok, g, torch.full_like(g, INT_MAX))
                         for (_, g, _, _, _, _), ok in zip(per, on_t)])
        win = [ok & (g == w) for (_, g, _, _, _, _), ok, w in zip(per, on_t, gw)]
        wf = [w.to(torch.float32)[:, None] for w in win]
        nrm = psum(mesh, [p[3] * f for p, f in zip(per, wf)])[0]
        uv = psum(mesh, [p[5] * f for p, f in zip(per, wf)])[0]
        mat = psum(mesh, [torch.where(w, p[4], torch.zeros_like(p[4]))
                          for p, w in zip(per, win)])[0]
        hit_any = psum(mesh, [p[2].to(torch.int32) for p in per])[0] > 0
        return _merge_spheres(scene, o, d, tmin[0], gw[0], nrm, mat, uv, hit_any)

    return _sorted(combine, scene, orig.to(dev0).contiguous(), dirn.to(dev0).contiguous(), sort)


def trace_geometry_sharded_ring(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor,
                                mesh: Mesh, shards: GeometryShards, sort: bool = True) -> Hit:
    """Closest hit with rays AND triangles sharded: D blocks of ceil(N/D)
    rays (padded with origin 0, direction (1, 1, 1)) make D hops around the
    ring; at each, shard i walks the block it holds through its sub-BVH
    with K1 below the block's running best t, keeps a strictly closer hit,
    and passes block and winner to shard i + 1 -> Hit on the mesh's first
    device, prim_id the original mesh id."""
    if shards.n_shards != mesh.size:
        raise ValueError(f"{shards.n_shards} geometry shards for a mesh of {mesh.size}")
    D = mesh.size
    dev0 = mesh.devices[0]
    scene = scene.to(dev0)

    def ring(o, d):
        n = o.shape[0]
        blk = -(-n // D)
        pad = blk * D - n
        if pad:
            o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=o.device)])
            d = torch.cat([d, torch.ones((pad, 3), dtype=d.dtype, device=d.device)])
        o_b, d_b = mesh.split(o), mesh.split(d)
        # the running winner of each block, one list per field, entry i on shard i:
        # t, original id, normal, material, uv, hit
        best = [[torch.full((blk,), MISS_T - 2.0, device=x.device) for x in o_b],
                [torch.full((blk,), INT_MAX, dtype=torch.int32, device=x.device) for x in o_b],
                [torch.zeros((blk, 3), device=x.device) for x in o_b],
                [torch.zeros((blk,), dtype=torch.int32, device=x.device) for x in o_b],
                [torch.zeros((blk, 2), device=x.device) for x in o_b],
                [torch.zeros((blk,), dtype=torch.bool, device=x.device) for x in o_b]]
        for _ in range(D):
            for i, shard in enumerate(shards.shards):
                bt, bg, bn, bm, buv, bh = (f[i] for f in best)
                t, g, hit, nrm, mat, uv = _shard_hits(shard, o_b[i], d_b[i], bt)
                better = hit & (t < bt)
                new = (torch.where(better, t, bt), torch.where(better, g, bg),
                       torch.where(better[:, None], nrm, bn), torch.where(better, mat, bm),
                       torch.where(better[:, None], uv, buv), bh | better)
                for f, x in zip(best, new):
                    f[i] = x
            o_b, d_b = ppermute_next(mesh, o_b), ppermute_next(mesh, d_b)
            best = [ppermute_next(mesh, f) for f in best]
        bt, bg, bn, bm, buv, bh = (gather(mesh, f)[:n] for f in best)
        return _merge_spheres(scene, o[:n], d[:n], torch.where(bh, bt, torch.full_like(bt, MISS_T)),
                              bg, bn, bm, buv, bh)

    return _sorted(ring, scene, orig.to(dev0).contiguous(), dirn.to(dev0).contiguous(), sort)


# ---- the fused frame and the path-trace step, ray-sharded ----

@functools.lru_cache(maxsize=16)
def _fused_pixels(mesh: Mesh, width: int, height: int, textured: bool):
    """The fused frame's pixels per shard and their row-major index: tile
    order (in 8 x 4 warps on the card, Renderer's order there), padded with
    pixel (W-1, H-1) to 128 rays a shard, 1024 when textured (JAX's
    granularity) -> (px per shard, py per shard, row-major index [n] on the
    first device)."""
    warp = WARP_BLOCK if mesh.devices[0].type == "cuda" else None
    px, py = tiled_pixel_order(width, height, warp=warp)
    n = px.shape[0]
    pad = (-n) % (mesh.size * (1024 if textured else 128))
    px = np.concatenate([px, np.full(pad, width - 1, np.int32)])
    py = np.concatenate([py, np.full(pad, height - 1, np.int32)])
    flat = torch.from_numpy(py[:n].astype(np.int64) * width + px[:n]).to(mesh.devices[0])
    return mesh.split(torch.from_numpy(px)), mesh.split(torch.from_numpy(py)), flat


def render_frame_fused_multichip(tables: list, width: int, height: int, mesh: Mesh,
                                 shadows: bool = False, shade_tables: list | None = None,
                                 host: bool = True):
    """The whole frame through the frame kernels, ray-sharded: each shard
    renders its slice of the tile-ordered pixels with K2 (`render_primary`),
    or a textured scene with K3 then K4 (`render_deferred`,
    `texture_shade`; `shade_tables` per shard, `replicate_tables(mesh,
    scene, pack_shade_tables)`), every light looped over; the slices are
    gathered and scattered into the frame -> host float32 [H,W,3], or with
    host=False the device tensor on the mesh's first device."""
    textured = tables[0].scene.textures.textured
    if textured and shade_tables is None:
        raise ValueError("render_frame_fused_multichip: a textured scene needs shade_tables")
    pxs, pys, flat = _fused_pixels(mesh, width, height, textured)
    out = []
    for i, (t, px, py) in enumerate(zip(tables, pxs, pys)):
        if textured:
            gbuf = render_deferred(t, px, py, width, height, shadows=shadows)
            out.append(texture_shade(shade_tables[i], gbuf))
        else:
            out.append(render_primary(t, px, py, width, height, shadows=shadows))
    rgb = gather(mesh, out)
    fb = torch.zeros((height * width, 3), dtype=torch.float32, device=rgb.device)
    fb[flat] = rgb[:flat.shape[0]]
    fb = fb.reshape(height, width, 3)
    return fb.cpu().numpy() if host else fb


def pathtrace_step_sharded(tables: list, accum: torch.Tensor, step_idx: int, px: torch.Tensor,
                           py: torch.Tensor, mesh: Mesh, *, width: int, height: int,
                           channel: int = 3, max_depth: int = 4, rr_start: int = 2,
                           shadows: bool = True, antialias: bool = True, spp: int = 1,
                           qmc: bool = True, qmc_seed: int = 0, tex_lod_bias: float = 0.0,
                           rng_seed: int = 0):
    """One progressive path-trace step with the pixel batch split over the
    mesh: each shard traces its block through `engine/pathtracer.py
    ::_sample_chunk` (one pool, K6 five times on the card), its lanes' QMC
    identity global (pixel id base i * block, sample index step_idx), so
    with QMC every lane draws the single-device sample. `tables`: per shard,
    `replicate_tables(mesh, scene, pack_bounce_tables)`. With sampler "rng"
    shard i draws the stream of seed light_seed(i, rng_seed): another sample
    than the single device's, of the same distribution -> (accum +
    contribution [C,3], per-depth counts summed over the shards), on the
    mesh's first device."""
    n = px.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} pixels do not divide over {mesh.size} shards")
    blk = n // mesh.size
    out, counts = [], []
    for i, (t, a, pxs, pys) in enumerate(zip(tables, mesh.split(accum), mesh.split(px),
                                             mesh.split(py))):
        contrib, cnt = _sample_chunk(t, pxs, pys, width, height, channel, max_depth, rr_start,
                                     shadows, antialias, spp=spp, qmc=qmc, sample_base=step_idx,
                                     qmc_seed=qmc_seed, qmc_pid_base=i * blk,
                                     tex_lod_bias=tex_lod_bias,
                                     rng_seed=light_seed(i, rng_seed) & 0xFFFFFFFF,
                                     fov_scale=t.render.fov_scale)
        out.append(a + contrib)
        counts.append(cnt)
    return gather(mesh, out), psum(mesh, counts)[0]
