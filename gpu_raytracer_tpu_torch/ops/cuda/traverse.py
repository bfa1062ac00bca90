"""K1: wide-BVH (4 or 8 children) closest-hit / any-hit traversal, one ray
per thread (CUDA).

Replaces the TPU kernel `gpu_raytracer_tpu/ops/pallas/traverse.py`
(`pallas_packet_traverse` -> `traverse_best` -> `_ordered_traverse4`).
The kernel source is csrc/traverse.cuh (the device function, which the
fused render kernel calls too) and csrc/traverse.cu (the standalone
launch). Its plain version is `ops/trace.py::traverse_triangles`.
`trace` is the closest hit of a ray batch (ops/trace.py::Hit) with the
triangles through K1: the path tracer's G-buffer and temporal warp.
`traverse_threaded` is K1's unordered walk (csrc/traverse_threaded.cu, the
walk csrc/threaded_walk.cuh), the counterpart of
`pallas_packet_traverse(..., ordered=False)`, over its own binary node table
of 32-byte records (`pack_threaded_tables`); no main path calls it.

The scene tables are laid out for the GPU here, once per scene:

  * nodes [Q,8w] f32, w = 4 or 8 the BVH's width (`TraceTables.width`):
    one record per wide node, 128-byte aligned: child boxes as lo_x[w],
    lo_y[w], lo_z[w], hi_x[w], hi_y[w], hi_z[w], then code[w] (a wide node
    id >= 0, or a leaf as the traversal stack's leaf code -1 - (first
    triangle slot << 4 | count), or -1 for an empty slot), the axis the
    children are sorted on, w - 1 pad words. A width-4 record is 32 words,
    one 128-byte cache line; a width-8 record 64 words, two lines (twelve
    float4 of boxes, two int4 of codes, the axis). The integer fields are
    int32 bit patterns in the f32 tensor; `unpack_nodes` reads a table
    back. Each width has its own kernel instances, chosen by the width the
    tables carry: a width-8 table launches the width-8 walk or raises.
  * tris [Tp,12] f32: three float4 per leaf-ordered triangle slot:
    (v0, material as int32 bits), (e1, 0), (e2, 0).

  * attrs [Tp,8] f32: two float4 per slot, (uv0, uv1), (uv2, decoded uv
    density, 0): what the deferred trace kernel reads once for the winner
    of a textured scene (its uv and mip footprint).

A single-leaf tree (no wide overlay) becomes one width-4 node whose slot 0
is the leaf under an all-enclosing box. The per-thread stack holds at most
(w - 1) x (wide depth) + 1 entries; the host computes that bound from a
host-built tree, or takes LBVH_WIDE_DEPTH for a rebuilt one (always width
4), and picks the smallest stack compiled for the width that holds it, or
raises.

A refit scene (models/scene.py::refit_scene) takes its tables along in
`refit_trace_tables`: after a topology refit the box words of every node
line and the triangle and attribute rows are rewritten in place (the tables
keep their shapes and device addresses); after a rebuild they are packed
anew, at width 4 whatever the width before. Neither reads anything back
from the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...models.scene import LBVH_DEPTH, Scene
from ..texture import den_decode
from ..bvh_traverse import bvh_traverse_threaded
from ..trace import Hit, slot_attributes, traverse_triangles
from ..trace import trace as plain_trace
from .build import check, load_kernels, tally

STACK_SIZES = (16, 32, 64, 128)   # stack capacities compiled at width 4 (csrc/traverse.cu)
# and at width 8, where 16 entries would hold only a two-level tree
WIDE_STACK_SIZES = {4: STACK_SIZES, 8: (32, 64, 128)}
# BVH4 levels of a rebuilt tree (Bvh.depth == LBVH_DEPTH), a bound known
# without reading the tree: a Karras node's range strictly lengthens its
# parent's common prefix, at most 63 bits of code and index tie-break, so
# the binary tree has at most 62 levels of internal nodes; the even-depth
# collapse keeps every other level, at most 31 (ops/lbvh.py::collapse4_device).
# 32 levels need 3 * 32 + 1 = 97 stack entries: the 128-entry stack.
LBVH_WIDE_DEPTH = 32
NODE_WORDS = 32                   # f32 words of a width-4 node record (8 per child slot)
NODE_BYTES = 4 * NODE_WORDS       # the alignment of every node table: one 128-byte line
_BIG = 3.0e38


@dataclass
class TraceTables:
    scene: Scene            # the scene the tables were packed from (plain path)
    nodes: torch.Tensor     # [Q,8*width] f32, 128-byte aligned on the card
    tris: torch.Tensor      # [Tp,12] f32
    attrs: torch.Tensor     # [Tp,8] f32 winner attributes (uvs, density)
    depth: int              # wide levels of internal nodes
    stack: int              # compiled stack capacity the kernels use
    width: int = 4          # children per node record: 4 or 8

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


def wide_arrays(scene: Scene):
    """The wide overlay of a scene as (q_min [Q,w,3] f32, q_max [Q,w,3] f32,
    q_child [Q,w] i32, q_leafc [Q,w] i32, q_axis [Q] i32, depth), w = 4 or 8.
    A single-leaf tree (no overlay) becomes one width-4 node whose slot 0 is
    the leaf under a box no ray misses, slots 1-3 empty."""
    bvh = scene.bvh
    dev = scene.device
    if bvh.has_wide:
        depth = (LBVH_WIDE_DEPTH if bvh.depth == LBVH_DEPTH else   # rebuilt: no host read
                 wide_depth(bvh.q_child.cpu().numpy(), bvh.q_leafc.cpu().numpy()))
        return bvh.q_min.float(), bvh.q_max.float(), bvh.q_child, bvh.q_leafc, bvh.q_axis, depth
    q_min = torch.full((1, 4, 3), 1e30, device=dev)
    q_max = torch.full((1, 4, 3), 1e30, device=dev)
    q_min[0, 0] = -_BIG
    q_max[0, 0] = _BIG
    n0 = int(bvh.tri_count[0])
    child = torch.tensor([[int(bvh.tri_start[0]) if n0 else -1, -1, -1, -1]],
                         dtype=torch.int32, device=dev)
    count = torch.tensor([[n0, 0, 0, 0]], dtype=torch.int32, device=dev)
    return q_min, q_max, child, count, torch.zeros((1,), dtype=torch.int32, device=dev), 1


def node_boxes(q_min, q_max) -> torch.Tensor:
    """The 6w box words of each node record [Q,6w]: lo_x[w] ... hi_z[w]."""
    return torch.cat([q_min[:, :, 0], q_min[:, :, 1], q_min[:, :, 2],
                      q_max[:, :, 0], q_max[:, :, 1], q_max[:, :, 2]], dim=1)


def pack_nodes(q_min, q_max, q_child, q_leafc, q_axis) -> torch.Tensor:
    """[Q,8w] f32 node records (the module docstring's layout) from the
    wide arrays of `wide_arrays`, w = q_child.shape[1] (4 or 8)."""
    width = q_child.shape[1]
    if width not in WIDE_STACK_SIZES:
        raise ValueError(f"pack_nodes: {width} children per node; the kernels take 4 or 8")
    child, count = q_child.to(torch.int32), q_leafc.to(torch.int32)
    leaf = -1 - ((child << 4) | count)
    code = torch.where(child < 0, torch.full_like(child, -1),
                       torch.where(count > 0, leaf, child))
    pad = torch.zeros((child.shape[0], width - 1), dtype=torch.float32, device=child.device)
    return torch.cat([node_boxes(q_min, q_max), _bits(code), _bits(q_axis[:, None]), pad],
                     dim=1).contiguous()


def unpack_nodes(nodes: torch.Tensor):
    """Node records [Q,8w] f32 -> (q_min, q_max, q_child, q_leafc, q_axis),
    the arrays `pack_nodes` was given."""
    w = nodes.shape[1] // 8
    boxes = nodes[:, :6 * w].reshape(-1, 6, w)
    q_min = boxes[:, 0:3].transpose(1, 2).contiguous()
    q_max = boxes[:, 3:6].transpose(1, 2).contiguous()
    ints = nodes[:, 6 * w:7 * w + 1].contiguous().view(torch.int32)
    code = ints[:, :w]
    packed = -1 - code
    is_leaf = code < -1
    child = torch.where(is_leaf, packed >> 4, code)
    count = torch.where(is_leaf, packed & 15, torch.zeros_like(code))
    return q_min, q_max, child, count, ints[:, w]


def pack_trace_tables(scene: Scene) -> TraceTables:
    """The GPU node and triangle tables of a scene, on the scene's device."""
    bvh = scene.bvh
    dev = scene.device
    # a leaf is the code -1 - (first slot << 4 | count) in an int32
    if bvh.max_leaf > 15 or scene.tri_v0.shape[0] >= 1 << 27:
        raise ValueError(f"leaves of up to {bvh.max_leaf} of {scene.tri_v0.shape[0]} "
                         f"triangle slots do not fit the kernels' 4+27-bit leaf code")
    q_min, q_max, child, count, axis, depth = wide_arrays(scene)
    nodes = pack_nodes(q_min, q_max, child, count, axis)
    width = child.shape[1]
    zero = torch.zeros((scene.tri_v0.shape[0], 1), dtype=torch.float32, device=dev)
    attrs = torch.cat([scene.tri_uv.reshape(-1, 6), den_decode(scene.tri_den)[:, None],
                       zero], dim=1).contiguous()
    return TraceTables(scene, nodes, triangle_rows(scene), attrs, depth,
                       stack_capacity(depth, width), width)


def triangle_rows(scene: Scene) -> torch.Tensor:
    """[Tp,12] f32, three float4 per leaf-ordered slot: (v0, material as
    int32 bits), (e1, 0), (e2, 0): the triangle table of every walk."""
    zero = torch.zeros((scene.tri_v0.shape[0], 1), dtype=torch.float32, device=scene.device)
    return torch.cat([scene.tri_v0, _bits(scene.tri_mat[:, None]),
                      scene.tri_e1, zero, scene.tri_e2, zero], dim=1).contiguous()


def refit_trace_tables(tables: TraceTables, scene: Scene) -> None:
    """Point `tables` at `scene`, a refit of `tables.scene`
    (models/scene.py::refit_scene). A topology refit keeps the tree's
    tensors: the 24 box words of each node line, the triangle rows (v0, e1,
    e2) and the attribute rows' density are rewritten in place, and the
    child codes, axes, depth and stack stay. A rebuild brings another tree:
    the tables are packed anew (a fresh, aligned node table of the rebuilt
    tree's width, 4). Either way nothing is read back from the device."""
    old = tables.scene
    if scene.bvh.left is not old.bvh.left or scene.tri_v0.shape != old.tri_v0.shape:
        fresh = pack_trace_tables(scene)
        tables.nodes, tables.tris, tables.attrs = fresh.nodes, fresh.tris, fresh.attrs
        tables.depth, tables.stack, tables.width = fresh.depth, fresh.stack, fresh.width
    else:
        if scene.bvh.has_wide:
            tables.nodes[:, :6 * tables.width] = node_boxes(scene.bvh.q_min.float(),
                                                            scene.bvh.q_max.float())
        tables.tris[:, 0:3] = scene.tri_v0
        tables.tris[:, 4:7] = scene.tri_e1
        tables.tris[:, 8:11] = scene.tri_e2
        tables.attrs[:, 6] = den_decode(scene.tri_den)
    tables.scene = scene


def nodes_ptr(tables: TraceTables) -> int:
    """The node table's device address for a kernel launch: the kernels read
    a record as whole aligned 128-byte lines (one at width 4, two at width
    8), so any other alignment (a view into a larger buffer) or shape, or a
    table whose records are not of the tables' width, is refused."""
    nodes = tables.nodes
    words = 8 * tables.width
    if (tables.width not in WIDE_STACK_SIZES or nodes.dtype != torch.float32
            or nodes.dim() != 2 or nodes.shape[1] != words or not nodes.is_contiguous()):
        raise ValueError(f"nodes: want contiguous float32 [Q,{words}] (width 4: [Q,32], "
                         f"width 8: [Q,64]), got {nodes.dtype} {tuple(nodes.shape)} at width "
                         f"{tables.width}")
    ptr = nodes.data_ptr()
    if ptr % NODE_BYTES:
        raise ValueError(f"nodes: the table starts at {ptr:#x}, not on a {NODE_BYTES}-byte "
                         f"boundary")
    return ptr


def stack_capacity(depth: int, width: int = 4) -> int:
    """The smallest stack compiled for `width` that holds a traversal of a
    wide BVH with `depth` levels of internal nodes: each level leaves at most
    width - 1 siblings behind, so (width - 1) * depth + 1 entries (3 * depth
    + 1 at width 4)."""
    sizes = WIDE_STACK_SIZES.get(width)
    if sizes is None:
        raise ValueError(f"width {width}: the kernels are compiled for widths 4 and 8")
    need = (width - 1) * depth + 1
    fits = [s for s in sizes if s >= need]
    if not fits:
        raise ValueError(f"width-{width} depth {depth} needs a {need}-entry traversal stack; "
                         f"the kernels are compiled for at most {sizes[-1]}")
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
    launch the kernel instance of the tables' width (counted in LAUNCHES as
    k1_standalone, or k1_standalone_w8 at width 8), CPU tensors take the
    plain version."""
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
    nodes = nodes_ptr(tables)
    tally("k1_standalone", tables.width)
    check(k.lib.rt_traverse(nodes, tables.tris.data_ptr(), tables.width, tables.stack,
                            orig.data_ptr(), dirn.data_ptr(), max_t.data_ptr(), N,
                            int(any_hit), t.data_ptr(), slot.data_ptr(),
                            normal.data_ptr(), mat.data_ptr(), stream), "rt_traverse")
    return t, slot, slot >= 0, normal, mat


@dataclass
class ThreadedTables:
    """The tables of K1's unordered walk (csrc/threaded_walk.cuh)."""
    scene: Scene            # the scene the tables were packed from (plain path)
    nodes: torch.Tensor     # [Nn,8] f32 binary nodes, 32-byte aligned on the card
    tris: torch.Tensor      # [Tp,12] f32, `triangle_rows`
    lean: bool = False      # no box plane is NaN: tame rays take the lean box test

    @property
    def device(self) -> torch.device:
        return self.nodes.device


THREADED_WORDS = 8   # f32 words of a binary node record: two float4, one 32-byte sector
LEAF_COUNT_BITS = 4  # a leaf code holds first slot << 4 | count


def pack_threaded_tables(scene: Scene) -> ThreadedTables:
    """The binary BVH as [Nn,8] f32 records: min.xyz, max.xyz, then as int32
    bits `enter` (the left child of an internal node; a leaf's code -1 -
    (first slot << 4 | count)) and the miss link; with K1's triangle rows.
    Raises for a tree whose leaves' hit and miss links differ, whose leaf
    does not fit its code, or where a child box does not lie inside its
    parent's (the walk's postponed leaves need nested boxes). Reads back
    whether the box planes are free of NaN (`lean`)."""
    bvh = scene.bvh
    leaf = bvh.left < 0
    first, count = bvh.tri_start.long(), bvh.tri_count.long()
    if not torch.equal(bvh.hit_link[leaf], bvh.miss_link[leaf]):
        raise ValueError("pack_threaded_tables: a leaf's hit link differs from its miss link")
    if leaf.any() and (int(count[leaf].min()) < 0
                       or int(count[leaf].max()) >= 1 << LEAF_COUNT_BITS
                       or int(first[leaf].min()) < 0
                       or int(first[leaf].max()) >= 1 << (31 - LEAF_COUNT_BITS)):
        raise ValueError("pack_threaded_tables: a leaf's first slot or count does not fit "
                         "its code")
    enter = torch.where(leaf, -1 - (first << LEAF_COUNT_BITS | count), bvh.hit_link.long())
    nodes = torch.cat([bvh.node_min.float(), bvh.node_max.float(),
                       _bits(torch.stack([enter, bvh.miss_link.long()], dim=1))],
                      dim=1).contiguous()
    lo, hi = bvh.node_min, bvh.node_max
    inner = torch.nonzero(~leaf).squeeze(1)
    # a box with a NaN plane is never entered, whatever best_t: it passes
    if any(bool(((lo[c] < lo[inner]) | (hi[c] > hi[inner])).any())
           for c in (bvh.left[inner].long(), bvh.right[inner].long())):
        raise ValueError("pack_threaded_tables: a child box does not lie inside its parent's")
    lean = not bool(torch.isnan(lo).any() or torch.isnan(hi).any())
    return ThreadedTables(scene, nodes, triangle_rows(scene), lean)


def traverse_threaded(tables: ThreadedTables, orig: torch.Tensor, dirn: torch.Tensor,
                      max_t: torch.Tensor, any_hit: bool = False,
                      past: torch.Tensor | None = None):
    """K1's unordered walk: triangle closest hit (or, with any_hit, the
    closest slot of the first leaf that blocks) below max_t in the binary
    tree's left-first order over its threaded hit / miss links -> what
    `traverse` returns: (t [N] f32, MISS_T on a miss; slot [N] or -1; hit
    [N] bool; unit normal [N,3] f32, 0 on a miss; material [N] or -1). CUDA
    tensors launch csrc/traverse_threaded.cu (counted in LAUNCHES as
    k1_threaded), CPU tensors take its plain version,
    ops/bvh_traverse.py::bvh_traverse_threaded.
    With `past` (int32 [N] on the card) the kernel's counting instance runs
    and also writes there each ray's node visits made with a leaf pending
    (the plain walk makes none, so the CPU has nothing to count). No main
    path calls it."""
    N = _check_rays(tables, orig, dirn, max_t)
    scene = tables.scene
    if past is not None and (past.device != orig.device or orig.device.type != "cuda"
                             or past.dtype != torch.int32 or tuple(past.shape) != (N,)
                             or not past.is_contiguous()):
        raise ValueError(f"past: want contiguous int32 [{N}] on the rays' card, got "
                         f"{past.dtype} {tuple(past.shape)} on {past.device}")
    if orig.device.type == "cpu":
        t, slot, hit = bvh_traverse_threaded(scene.bvh, scene.tri_v0, scene.tri_e1,
                                             scene.tri_e2, orig, dirn, max_t,
                                             leaf_size=scene.bvh.max_leaf, any_hit=any_hit)
        return (t, slot, hit) + slot_attributes(scene, slot, hit)
    if orig.device.type != "cuda":
        raise ValueError(f"traverse_threaded: unsupported device {orig.device}")
    nodes = tables.nodes
    if (nodes.dtype != torch.float32 or nodes.dim() != 2 or nodes.shape[1] != THREADED_WORDS
            or not nodes.is_contiguous() or nodes.data_ptr() % 32):
        raise ValueError(f"nodes: want contiguous float32 [Nn,{THREADED_WORDS}] on a 32-byte "
                         f"boundary, got {nodes.dtype} {tuple(nodes.shape)}")
    k = load_kernels()
    t = torch.empty((N,), dtype=torch.float32, device=orig.device)
    slot = torch.empty((N,), dtype=torch.int32, device=orig.device)
    normal = torch.empty((N, 3), dtype=torch.float32, device=orig.device)
    mat = torch.empty((N,), dtype=torch.int32, device=orig.device)
    stream = torch.cuda.current_stream(orig.device).cuda_stream
    tally("k1_threaded")
    check(k.lib.rt_traverse_threaded(nodes.data_ptr(), nodes.shape[0], int(tables.lean),
                                     tables.tris.data_ptr(),
                                     orig.data_ptr(), dirn.data_ptr(), max_t.data_ptr(), N,
                                     int(any_hit), t.data_ptr(), slot.data_ptr(),
                                     normal.data_ptr(), mat.data_ptr(),
                                     None if past is None else past.data_ptr(), stream),
          "rt_traverse_threaded")
    return t, slot, slot >= 0, normal, mat


def trace(tables: TraceTables, orig: torch.Tensor, dirn: torch.Tensor, max_t=None) -> Hit:
    """Closest hit for a ray batch orig/dirn [N,3] f32 -> ops/trace.py::Hit,
    composed as the plain `trace` is: the sphere pass in PyTorch, the
    triangles through K1 (`traverse`) below the sphere's t (strict <, so the
    sphere keeps a tie), the winner triangle's uv from its slot, the sphere
    normal and uv. CPU tensors take the plain `ops/trace.py::trace`; on a
    CUDA tensor the triangles never take the plain walk."""
    if orig.device.type == "cpu":
        return plain_trace(tables.scene, orig, dirn, max_t)

    def k1(scene, o, d, limit):
        t, slot, hit, normal, mat = traverse(tables, o.contiguous(), d.contiguous(), limit)
        return t, slot.long(), hit, normal, mat.long()

    return plain_trace(tables.scene, orig, dirn, max_t, triangles=k1)


def traversal_work(tables: TraceTables, orig: torch.Tensor, dirn: torch.Tensor,
                   max_t: torch.Tensor, any_hit: bool = False) -> torch.Tensor:
    """The work of K1's own walk for each ray -> [N,5] int32: node records
    visited, triangles intersected, the iterations of the node body and of
    the triangle body that the ray's lane led for its warp of 32 consecutive
    rays, and the non-empty child slots of the visited records. Over a
    launch sum(nodes) / (32 * sum(warp nodes)) is the SIMT efficiency of the
    node body, and the same for the triangles; the slots and the triangles
    are the slab and triangle tests the closest hit needs (the operation
    count of the kernels' roofline bound: a visit also slab-tests its empty
    slots, work the function does not need). A measurement on the card,
    only for CUDA tensors: the plain traversal walks the binary tree, a
    different count. A node is a record of the tables' width."""
    N = _check_rays(tables, orig, dirn, max_t)
    if orig.device.type != "cuda":
        raise ValueError(f"traversal_work: counts the CUDA walk, got {orig.device}")
    k = load_kernels()
    work = torch.empty((N, 5), dtype=torch.int32, device=orig.device)
    stream = torch.cuda.current_stream(orig.device).cuda_stream
    check(k.lib.rt_traverse_work(nodes_ptr(tables), tables.tris.data_ptr(), tables.width,
                                 tables.stack,
                                 orig.data_ptr(), dirn.data_ptr(), max_t.data_ptr(), N,
                                 int(any_hit), work.data_ptr(), None, stream), "rt_traverse_work")
    return work


def children_ahead(tables: TraceTables, orig: torch.Tensor, dirn: torch.Tensor,
                   max_t: torch.Tensor, any_hit: bool = False) -> torch.Tensor:
    """How many children of each visited width-8 record lie ahead of the
    ray in K1's own walk -> [9] int64: entry k counts the visits of the
    batch with k children ahead (their box entered below the ray's best t).
    k = 0 and 1 need no ordering, k >= 2 pay for it. A measurement on the
    card (the counting walk, as traversal_work), of width-8 tables only."""
    N = _check_rays(tables, orig, dirn, max_t)
    if orig.device.type != "cuda":
        raise ValueError(f"children_ahead: counts the CUDA walk, got {orig.device}")
    if tables.width != 8:
        raise ValueError(f"children_ahead: counts width-8 visits, got width {tables.width}")
    k = load_kernels()
    work = torch.empty((N, 5), dtype=torch.int32, device=orig.device)
    ahead = torch.zeros((9,), dtype=torch.int32, device=orig.device)
    stream = torch.cuda.current_stream(orig.device).cuda_stream
    check(k.lib.rt_traverse_work(nodes_ptr(tables), tables.tris.data_ptr(), tables.width,
                                 tables.stack, orig.data_ptr(), dirn.data_ptr(),
                                 max_t.data_ptr(), N, int(any_hit), work.data_ptr(),
                                 ahead.data_ptr(), stream), "rt_traverse_work")
    return ahead.long()
