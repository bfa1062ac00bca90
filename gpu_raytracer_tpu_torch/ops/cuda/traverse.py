"""K1: BVH4 closest-hit / any-hit traversal, one ray per thread (CUDA).

Replaces the TPU kernel `gpu_raytracer_tpu/ops/pallas/traverse.py`
(`pallas_packet_traverse` -> `traverse_best` -> `_ordered_traverse4`).
The kernel source is csrc/traverse.cuh (the device function, which the
fused render kernel calls too) and csrc/traverse.cu (the standalone
launch). Its plain version is `ops/trace.py::traverse_triangles`.

The scene tables are laid out for the GPU here, once per scene:

  * nodes [Q,36] f32: one 144-byte record per BVH4 node, 16-byte aligned:
    child boxes as lo_x[4], lo_y[4], lo_z[4], hi_x[4], hi_y[4], hi_z[4],
    then child[4] (wide node id, or first triangle slot of a leaf, or -1),
    count[4] (leaf triangle count, 0 for an internal or empty slot), the
    axis the children are sorted on, 3 pad words. The integer fields are
    int32 bit patterns in the f32 tensor.
  * tris [Tp,12] f32: three float4 per leaf-ordered triangle slot:
    (v0, material as int32 bits), (e1, 0), (e2, 0).

  * attrs [Tp,8] f32: two float4 per slot, (uv0, uv1), (uv2, decoded uv
    density, 0): what the deferred trace kernel reads once for the winner
    of a textured scene (its uv and mip footprint).

A single-leaf tree (no BVH4 overlay) becomes one node whose slot 0 is the
leaf under an all-enclosing box. The per-thread stack holds at most
3 x (BVH4 depth) + 1 entries; the host computes that bound and picks the
smallest compiled stack that holds it, or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...models.scene import Scene
from ..texture import den_decode
from ..trace import traverse_triangles
from .build import check, load_kernels

STACK_SIZES = (16, 32, 64, 128)   # compiled stack capacities (csrc/traverse.cu)
_BIG = 3.0e38


@dataclass
class TraceTables:
    scene: Scene            # the scene the tables were packed from (plain path)
    nodes: torch.Tensor     # [Q,36] f32
    tris: torch.Tensor      # [Tp,12] f32
    attrs: torch.Tensor     # [Tp,8] f32 winner attributes (uvs, density)
    depth: int              # BVH4 levels of internal nodes
    stack: int              # compiled stack capacity the kernels use

    @property
    def device(self) -> torch.device:
        return self.nodes.device


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous().view(torch.float32)


def wide_depth(q_child: np.ndarray, q_leafc: np.ndarray) -> int:
    """Levels of internal nodes on the deepest root-to-leaf path."""
    depth = np.zeros(q_child.shape[0], np.int64)
    depth[0] = 1
    queue = [0]
    for q in queue:   # breadth first; every node is reached once
        for c, lc in zip(q_child[q], q_leafc[q]):
            if c >= 0 and lc == 0:
                depth[c] = depth[q] + 1
                queue.append(int(c))
    return int(depth.max())


def pack_trace_tables(scene: Scene) -> TraceTables:
    """The GPU node and triangle tables of a scene, on the scene's device."""
    bvh = scene.bvh
    dev = scene.device
    # a stack entry packs a leaf as (first slot << 4 | count) in an int32
    if bvh.max_leaf > 15 or scene.tri_v0.shape[0] >= 1 << 27:
        raise ValueError(f"leaves of up to {bvh.max_leaf} of {scene.tri_v0.shape[0]} "
                         f"triangle slots do not fit the kernels' 4+27-bit leaf code")
    if bvh.has_wide:
        if bvh.q_child.shape[1] != 4:
            raise NotImplementedError("BVH width 8 is not ported yet")
        q_min, q_max = bvh.q_min.float(), bvh.q_max.float()
        child, count, axis = bvh.q_child, bvh.q_leafc, bvh.q_axis
        depth = wide_depth(child.cpu().numpy(), bvh.q_leafc.cpu().numpy())
    else:
        # one leaf: slot 0 under a box no ray misses, slots 1-3 empty
        q_min = torch.full((1, 4, 3), 1e30, device=dev)
        q_max = torch.full((1, 4, 3), 1e30, device=dev)
        q_min[0, 0] = -_BIG
        q_max[0, 0] = _BIG
        n0 = int(bvh.tri_count[0])
        child = torch.tensor([[int(bvh.tri_start[0]) if n0 else -1, -1, -1, -1]],
                             dtype=torch.int32, device=dev)
        count = torch.tensor([[n0, 0, 0, 0]], dtype=torch.int32, device=dev)
        axis = torch.zeros((1,), dtype=torch.int32, device=dev)
        depth = 1
    Q = child.shape[0]
    nodes = torch.cat(
        [q_min[:, :, 0], q_min[:, :, 1], q_min[:, :, 2],
         q_max[:, :, 0], q_max[:, :, 1], q_max[:, :, 2],
         _bits(child), _bits(count), _bits(axis[:, None]),
         torch.zeros((Q, 3), dtype=torch.float32, device=dev)], dim=1).contiguous()
    zero = torch.zeros((scene.tri_v0.shape[0], 1), dtype=torch.float32, device=dev)
    tris = torch.cat([scene.tri_v0, _bits(scene.tri_mat[:, None]),
                      scene.tri_e1, zero, scene.tri_e2, zero], dim=1).contiguous()
    attrs = torch.cat([scene.tri_uv.reshape(-1, 6), den_decode(scene.tri_den)[:, None],
                       zero], dim=1).contiguous()
    return TraceTables(scene, nodes, tris, attrs, depth, stack_capacity(depth))


def stack_capacity(depth: int) -> int:
    """The smallest compiled stack that holds a traversal of a BVH4 with
    `depth` levels of internal nodes: each level leaves at most 3 siblings
    behind and the deepest pushes 4, so 3 * depth + 1 entries."""
    need = 3 * depth + 1
    fits = [s for s in STACK_SIZES if s >= need]
    if not fits:
        raise ValueError(f"BVH4 depth {depth} needs a {need}-entry traversal stack; "
                         f"the kernels are compiled for at most {STACK_SIZES[-1]}")
    return fits[0]


def _check_rays(tables: TraceTables, orig, dirn, max_t) -> int:
    N = orig.shape[0]
    for name, x, shape in (("orig", orig, (N, 3)), ("dirn", dirn, (N, 3)),
                           ("max_t", max_t, (N,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous float32 {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != tables.device:
            raise ValueError(f"{name} is on {x.device}, the tables on {tables.device}")
    return N


def traverse(tables: TraceTables, orig: torch.Tensor, dirn: torch.Tensor,
             max_t: torch.Tensor, any_hit: bool = False):
    """Triangle closest hit (or any hit) below max_t -> (t [N] f32, MISS_T
    on a miss; slot [N] or -1; hit [N] bool; unit normal [N,3] f32, 0 on a
    miss; material [N] or -1). With any_hit the ray stops at the first
    blocker found: only hit (and the blocker's t and slot) are defined, and
    which blocker is found depends on the traversal order. CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    N = _check_rays(tables, orig, dirn, max_t)
    if orig.device.type == "cpu":
        return traverse_triangles(tables.scene, orig, dirn, max_t, any_hit=any_hit)
    if orig.device.type != "cuda":
        raise ValueError(f"traverse: unsupported device {orig.device}")
    k = load_kernels()
    t = torch.empty((N,), dtype=torch.float32, device=orig.device)
    slot = torch.empty((N,), dtype=torch.int32, device=orig.device)
    normal = torch.empty((N, 3), dtype=torch.float32, device=orig.device)
    mat = torch.empty((N,), dtype=torch.int32, device=orig.device)
    stream = torch.cuda.current_stream(orig.device).cuda_stream
    traverse.launches += 1
    check(k.lib.rt_traverse(tables.nodes.data_ptr(), tables.tris.data_ptr(), tables.stack,
                            orig.data_ptr(), dirn.data_ptr(), max_t.data_ptr(), N,
                            int(any_hit), t.data_ptr(), slot.data_ptr(),
                            normal.data_ptr(), mat.data_ptr(), stream), "rt_traverse")
    return t, slot, slot >= 0, normal, mat


traverse.launches = 0


def traversal_work(tables: TraceTables, orig: torch.Tensor, dirn: torch.Tensor,
                   max_t: torch.Tensor, any_hit: bool = False) -> torch.Tensor:
    """The work of K1's own walk for each ray -> [N,2] int32 (node records
    slab-tested, triangles intersected): a measurement on the card, for
    the operation count of the kernels' roofline bound. Only CUDA tensors:
    the plain traversal walks the binary tree, a different count."""
    N = _check_rays(tables, orig, dirn, max_t)
    if orig.device.type != "cuda":
        raise ValueError(f"traversal_work: counts the CUDA walk, got {orig.device}")
    k = load_kernels()
    work = torch.empty((N, 2), dtype=torch.int32, device=orig.device)
    stream = torch.cuda.current_stream(orig.device).cuda_stream
    check(k.lib.rt_traverse_work(tables.nodes.data_ptr(), tables.tris.data_ptr(), tables.stack,
                                 orig.data_ptr(), dirn.data_ptr(), max_t.data_ptr(), N,
                                 int(any_hit), work.data_ptr(), stream), "rt_traverse_work")
    return work
