"""BVH: flattened node model, host-side build, leaf packing and BVH4 collapse.

Nodes hold an AABB, left/right children (-1 = leaf) and a contiguous
(start, count) range of leaf-ordered triangles. Threaded hit/miss links give
the left-first DFS order that the plain traversal walks; the width-4 overlay
(`q_*`) is what the CUDA traversal kernel walks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LEAF = -1  # child sentinel


@dataclass
class Bvh:
    node_min: torch.Tensor   # [N,3] f32
    node_max: torch.Tensor   # [N,3] f32
    left: torch.Tensor       # [N] i32, -1 if leaf
    right: torch.Tensor      # [N] i32, -1 if leaf
    tri_start: torch.Tensor  # [N] i32: first triangle (leaf-ordered arrays)
    tri_count: torch.Tensor  # [N] i32: triangles in leaf (0 for internal)
    # threaded links: on an AABB hit continue at hit_link (the left child,
    # or the miss target for leaves), on a miss at miss_link; -1 = done
    hit_link: torch.Tensor   # [N] i32
    miss_link: torch.Tensor  # [N] i32
    # every leaf's triangle range starts at a multiple of this (align_leaves)
    leaf_align: int = 1
    # upper bound on triangles per leaf
    max_leaf: int = 4
    # width-4 overlay (collapse4); None for a single-leaf tree
    q_child: torch.Tensor | None = None   # [Q,4] i32: wide id | tri_start | -1
    q_leafc: torch.Tensor | None = None   # [Q,4] i32 leaf tri count (0 = internal/empty)
    q_min: torch.Tensor | None = None     # [Q,4,3] f32
    q_max: torch.Tensor | None = None     # [Q,4,3] f32
    q_axis: torch.Tensor | None = None    # [Q] i32 axis the children are sorted on
    q_src: torch.Tensor | None = None     # [Q,4] i32 binary node behind each slot
    # max binary tree depth + 2
    depth: int = 64

    @property
    def has_wide(self) -> bool:
        return self.q_child is not None

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]


def compute_links(left: np.ndarray, right: np.ndarray):
    """Thread the tree for stackless left-first DFS -> (hit_link, miss_link)."""
    n = left.shape[0]
    miss = np.full(n, -1, np.int32)
    stack = [(0, -1)]
    while stack:
        node, succ = stack.pop()
        miss[node] = succ
        l, r = int(left[node]), int(right[node])
        if l >= 0:
            stack.append((r, succ))
            stack.append((l, r))
    hit = np.where(left >= 0, left, miss).astype(np.int32)
    return hit, miss


class BvhBuildResult:
    """Host-side build output (NumPy)."""

    def __init__(self, node_min, node_max, left, right, tri_start, tri_count,
                 tri_order, max_depth, leaf_align: int = 1):
        self.node_min = node_min
        self.node_max = node_max
        self.left = left
        self.right = right
        self.tri_start = tri_start
        self.tri_count = tri_count
        self.tri_order = tri_order      # [T] slot -> original id (-1 = pad)
        self.max_depth = max_depth
        self.leaf_align = leaf_align

    def to_tensors(self, width: int = 4) -> Bvh:
        from .bvh_native import collapse4_native

        hit_link, miss_link = compute_links(self.left, self.right)
        leaf_counts = np.asarray(self.tri_count)[np.asarray(self.left) < 0]
        max_leaf = int(leaf_counts.max()) if leaf_counts.size else 0
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        quad = {}
        if self.left.shape[0] > 1:
            if width != 4:
                raise NotImplementedError(
                    f"bvh_width={width}: the port's traversal takes a width-4 BVH")
            qc, ql, qmn, qmx, qax, qsrc = collapse4_native(
                self.left, self.right, self.tri_start, self.tri_count,
                self.node_min, self.node_max, width=width)
            quad = dict(q_child=t(qc), q_leafc=t(ql), q_min=t(qmn), q_max=t(qmx),
                        q_axis=t(qax), q_src=t(qsrc))
        return Bvh(node_min=t(self.node_min), node_max=t(self.node_max),
                   left=t(self.left), right=t(self.right),
                   tri_start=t(self.tri_start), tri_count=t(self.tri_count),
                   hit_link=t(hit_link), miss_link=t(miss_link),
                   leaf_align=self.leaf_align, max_leaf=max(max_leaf, 1),
                   depth=max(self.max_depth + 2, 8), **quad)


def collapse4(left, right, tri_start, tri_count, node_min, node_max,
              width: int = 4):
    """NumPy twin of the native wide collapse -> (q_child, q_leafc, q_min,
    q_max, q_axis, q_src).

    Each wide node replaces a binary internal node by up to `width`
    descendants, grown greedily by opening the candidate with the largest
    surface area. Children are sorted by centroid along the parent's longest
    axis; empty slots get child -1, count 0 and inert bounds."""
    FAR = 1e30
    is_leaf = left < 0
    ext = node_max - node_min
    d = np.maximum(ext, 0.0)
    sa = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    q_child, q_leafc, q_min, q_max, q_axis, q_src = [], [], [], [], [], []

    def emit(slots, axis):
        ch = np.full(width, -1, np.int64)
        lc = np.zeros(width, np.int64)
        mn = np.full((width, 3), FAR, np.float32)
        mx = np.full((width, 3), FAR, np.float32)
        srcs = np.full(width, -1, np.int64)
        for i, (c, l, lo, hi, s) in enumerate(slots):
            ch[i], lc[i], mn[i], mx[i], srcs[i] = c, l, lo, hi, s
        q_child.append(ch)
        q_leafc.append(lc)
        q_min.append(mn)
        q_max.append(mx)
        q_axis.append(axis)
        q_src.append(srcs)

    if is_leaf[0]:
        emit([(int(tri_start[0]), max(int(tri_count[0]), 0),
               node_min[0], node_max[0], 0)] if tri_count[0] > 0 else [], 0)
    else:
        qid = {0: 0}
        queue = [0]
        i = 0
        while i < len(queue):
            b = queue[i]
            i += 1
            cand = [int(left[b]), int(right[b])]
            while len(cand) < width:
                grow, grow_sa = -1, -1.0
                for j, c in enumerate(cand):
                    if not is_leaf[c] and sa[c] > grow_sa:
                        grow, grow_sa = j, float(sa[c])
                if grow < 0:
                    break
                c = cand.pop(grow)
                cand += [int(left[c]), int(right[c])]
            ax = int(np.argmax(ext[b]))
            cand.sort(key=lambda c: float(node_min[c, ax] + node_max[c, ax]))
            slots = []
            for c in cand:
                if is_leaf[c]:
                    if tri_count[c] > 0:  # empty leaves are inert: drop
                        slots.append((int(tri_start[c]), int(tri_count[c]),
                                      node_min[c], node_max[c], c))
                else:
                    q = qid.get(c)
                    if q is None:
                        q = qid[c] = len(qid)
                        queue.append(c)
                    slots.append((q, 0, node_min[c], node_max[c], c))
            emit(slots, ax)

    return (np.stack(q_child).astype(np.int32),
            np.stack(q_leafc).astype(np.int32),
            np.stack(q_min), np.stack(q_max),
            np.asarray(q_axis, np.int32),
            np.stack(q_src).astype(np.int32))


def align_leaves(res: BvhBuildResult, align: int = 8) -> BvhBuildResult:
    """Pack leaf triangle ranges into whole `align`-slot rows, first-fit
    decreasing (ties in tri_start order). Leaves smaller than a row share
    rows; unused tail slots pad with degenerates (tri_order -1). The JAX
    package's TPU kernels need the rows; the port keeps the packing because
    it fixes the leaf-ordered triangle table that both packages compare."""
    leaf_nodes = np.nonzero(res.left < 0)[0]
    starts = res.tri_start[leaf_nodes]
    counts = res.tri_count[leaf_nodes]
    if counts.size and int(counts.max()) > align:
        raise ValueError(
            f"align_leaves: leaf with {int(counts.max())} triangles exceeds "
            f"align={align}; build the BVH with leaf_size <= {align}")
    by = np.lexsort((starts, -counts))
    rows: list[list] = []            # row -> list of (node, offset)
    used: list[int] = []             # row -> slots used
    by_rem: list[list[int]] = [[] for _ in range(align + 1)]  # rem -> rows
    for li in by:
        node = int(leaf_nodes[li])
        c = int(counts[li])
        if c == 0:
            continue
        r = -1
        for rem in range(c, align + 1):
            while by_rem[rem] and used[by_rem[rem][-1]] != align - rem:
                by_rem[rem].pop()    # stale entry
            if by_rem[rem]:
                r = by_rem[rem].pop()
                break
        if r < 0:
            r = len(rows)
            rows.append([])
            used.append(0)
        rows[r].append((node, used[r]))
        used[r] += c
        by_rem[align - used[r]].append(r)

    new_order: list[np.ndarray] = []
    new_start = res.tri_start.copy()
    cur = 0
    for r, members in enumerate(rows):
        for node, off in members:
            s = int(res.tri_start[node])
            c = int(res.tri_count[node])
            new_start[node] = cur + off
            new_order.append(res.tri_order[s:s + c])
        pad = align - used[r]
        if pad:
            new_order.append(np.full(pad, -1, np.int64))
        cur += align
    # empty leaves point at a valid (all-pad) tail row
    empties = leaf_nodes[counts == 0]
    if empties.size:
        new_start[empties] = cur
        new_order.append(np.full(align, -1, np.int64))
        cur += align
    order = np.concatenate(new_order) if new_order else np.zeros((0,), np.int64)
    return BvhBuildResult(res.node_min, res.node_max, res.left, res.right,
                          new_start, res.tri_count, order, res.max_depth,
                          leaf_align=align)


def build_bvh(vertices: np.ndarray, indices: np.ndarray,
              leaf_size: int = 4) -> BvhBuildResult:
    """Binned-SAH top-down build through the native builder (root = node 0)."""
    from .bvh_native import build_bvh_native

    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.uint32)
    if indices.shape[0] == 0:
        return BvhBuildResult(
            np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
            np.asarray([LEAF], np.int32), np.asarray([LEAF], np.int32),
            np.asarray([0], np.int32), np.asarray([0], np.int32),
            np.zeros((0,), np.int64), 1)
    return build_bvh_native(vertices, indices, leaf_size)


def validate_bvh(res, num_triangles: int, allow_refs: bool = False) -> None:
    """Check a binary tree: every triangle reachable, each child's box inside
    its parent's (1e-6 slack), no triangle in two leaves (with `allow_refs`,
    spatial-split builds that reference a triangle from several leaves,
    coverage only). `res` is a BvhBuildResult, or any object with its node
    arrays (NumPy or tensors) and `tri_order` (slot -> triangle, -1 for a
    padding slot, which belongs to no triangle). Raises ValueError."""
    a = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    left, right, node_min, node_max = a(res.left), a(res.right), a(res.node_min), a(res.node_max)
    start, count, order = a(res.tri_start), a(res.tri_count), a(res.tri_order)
    seen = np.zeros(num_triangles, bool)
    stack = [0]
    while stack:
        n = stack.pop()
        if left[n] == LEAF:
            ids = order[start[n]:start[n] + count[n]]
            ids = ids[ids >= 0]
            if not allow_refs and seen[ids].any():
                raise ValueError(f"leaf {n}: a triangle is in two leaves")
            seen[ids] = True
        else:
            for ch in (int(left[n]), int(right[n])):
                if ((node_min[ch] < node_min[n] - 1e-6).any()
                        or (node_max[ch] > node_max[n] + 1e-6).any()):
                    raise ValueError(f"node {ch}'s box is outside its parent {n}'s")
                stack.append(ch)
    if not seen.all():
        raise ValueError(f"{int((~seen).sum())} triangles are in no leaf")


def scene_tree(scene) -> BvhBuildResult:
    """A scene's binary tree with its leaf slots' triangles (`tri_src`), as
    `validate_bvh` reads it."""
    b = scene.bvh
    return BvhBuildResult(b.node_min, b.node_max, b.left, b.right, b.tri_start, b.tri_count,
                          scene.tri_src, b.depth, leaf_align=b.leaf_align)
