"""BVH: flattened node model, host-side builds, leaf packing and the wide
(4- or 8-child) collapse.

Nodes hold an AABB, left/right children (-1 = leaf) and a contiguous
(start, count) range of leaf-ordered triangles. Threaded hit/miss links give
the left-first DFS order that the plain traversal walks; the wide overlay
(`q_*`, width 4 or 8) is what the CUDA traversal kernels walk.

Three host builders make the binary tree: the native binned-SAH builder
(`build_bvh`, the default), its NumPy twin (`build_bvh(..., use_native=False)`,
a choice of the caller, never a fallback) and the spatial-split builder
(`build_bvh_spatial`), whose leaves may reference a triangle more than once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .geometry import triangle_aabbs

LEAF = -1  # child sentinel
WIDTHS = (4, 8)   # children per node of the wide overlay


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
    # wide overlay of w = 4 or 8 children (collapse4); None for a single-leaf
    # tree. A rebuilt tree (ops/lbvh.py) is always width 4.
    q_child: torch.Tensor | None = None   # [Q,w] i32: wide id | tri_start | -1
    q_leafc: torch.Tensor | None = None   # [Q,w] i32 leaf tri count (0 = internal/empty)
    q_min: torch.Tensor | None = None     # [Q,w,3] f32
    q_max: torch.Tensor | None = None     # [Q,w,3] f32
    q_axis: torch.Tensor | None = None    # [Q] i32 axis the children are sorted on
    q_src: torch.Tensor | None = None     # [Q,w] i32 binary node behind each slot
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
        """The tree as tensors with its `width`-wide overlay (4 or 8),
        collapsed by the native library."""
        from .bvh_native import collapse4_native

        if width not in WIDTHS:
            raise ValueError(f"bvh_width={width}: the wide overlay takes 4 or 8 children")
        hit_link, miss_link = compute_links(self.left, self.right)
        leaf_counts = np.asarray(self.tri_count)[np.asarray(self.left) < 0]
        max_leaf = int(leaf_counts.max()) if leaf_counts.size else 0
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        quad = {}
        if self.left.shape[0] > 1:
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


_SAH_BINS = 16


def _empty_build() -> BvhBuildResult:
    return BvhBuildResult(
        np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
        np.asarray([LEAF], np.int32), np.asarray([LEAF], np.int32),
        np.asarray([0], np.int32), np.asarray([0], np.int32),
        np.zeros((0,), np.int64), 1)


def _areas(mn, mx):
    """Surface areas of the boxes (mn[k], mx[k])."""
    d = np.maximum(mx - mn, 0.0)
    return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])


def _area(mn, mx):
    d = np.maximum(mx - mn, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def build_bvh(vertices: np.ndarray, indices: np.ndarray, leaf_size: int = 4,
              use_native: bool = True) -> BvhBuildResult:
    """Binned-SAH top-down build (root = node 0): through the native builder,
    or with `use_native=False` in NumPy, the same algorithm node for node
    (the native builder numbers nodes as its worker threads finish; the NumPy
    build numbers them depth first). A native library that does not load
    raises: the NumPy build is never taken in its place."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.uint32)
    T = indices.shape[0]
    if T == 0:
        return _empty_build()
    if use_native:
        from .bvh_native import build_bvh_native

        return build_bvh_native(vertices, indices, leaf_size)

    tmin, tmax = triangle_aabbs(vertices, indices)
    centroid = 0.5 * (tmin + tmax)
    order = np.arange(T, dtype=np.int64)
    # every leaf holds >= 1 triangle: at most 2T - 1 nodes
    cap = max(2 * T + 2, 16)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left = np.full(cap, LEAF, np.int32)
    right = np.full(cap, LEAF, np.int32)
    tri_start = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    n_nodes = 1
    max_depth = 1

    stack = [(0, 0, T, 1)]   # (node, lo, hi, depth) over ranges of `order`
    while stack:
        node, lo, hi, depth = stack.pop()
        max_depth = max(max_depth, depth)
        ids = order[lo:hi]
        node_min[node] = tmin[ids].min(axis=0)
        node_max[node] = tmax[ids].max(axis=0)
        count = hi - lo
        if count <= leaf_size:
            tri_start[node] = lo
            tri_count[node] = count
            continue

        cen = centroid[ids]
        cmin, cmax = cen.min(axis=0), cen.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 0.0:   # every centroid the same: split by index
            mid = lo + count // 2
        else:
            scale = _SAH_BINS * (1.0 - 1e-6) / extent[axis]
            bins = ((cen[:, axis] - cmin[axis]) * scale).astype(np.int32)
            bins = np.clip(bins, 0, _SAH_BINS - 1)
            bin_cnt = np.bincount(bins, minlength=_SAH_BINS)
            bin_min = np.full((_SAH_BINS, 3), np.inf, np.float32)
            bin_max = np.full((_SAH_BINS, 3), -np.inf, np.float32)
            for a in range(3):
                np.minimum.at(bin_min[:, a], bins, tmin[ids][:, a])
                np.maximum.at(bin_max[:, a], bins, tmax[ids][:, a])
            # prefix and suffix sweeps: the SAH cost of the B - 1 planes
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_cnt)
            rcnt = count - lcnt
            cost = _areas(lmin, lmax)[:-1] * lcnt[:-1] + _areas(rmin[1:], rmax[1:]) * rcnt[:-1]
            cost = np.where((lcnt[:-1] == 0) | (rcnt[:-1] == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                mid = lo + count // 2
            else:
                go_left = bins <= best
                order[lo:hi] = np.concatenate([ids[go_left], ids[~go_left]])
                mid = lo + int(np.count_nonzero(go_left))
        if mid == lo or mid == hi:
            mid = lo + count // 2
        l_idx, r_idx = n_nodes, n_nodes + 1
        n_nodes += 2
        if n_nodes > cap:
            raise RuntimeError("BVH node capacity exceeded")
        left[node] = l_idx
        right[node] = r_idx
        stack.append((r_idx, mid, hi, depth + 1))
        stack.append((l_idx, lo, mid, depth + 1))

    return BvhBuildResult(node_min[:n_nodes].copy(), node_max[:n_nodes].copy(),
                          left[:n_nodes].copy(), right[:n_nodes].copy(),
                          tri_start[:n_nodes].copy(), tri_count[:n_nodes].copy(),
                          order, max_depth)


def build_bvh_spatial(vertices: np.ndarray, indices: np.ndarray, leaf_size: int = 8,
                      bins: int = 16, alpha: float = 1e-5,
                      max_dup: float = 1.35) -> BvhBuildResult:
    """Spatial-split (SBVH) top-down build, binned (Stich et al. 2009): at
    each node the binned-SAH object split competes with a spatial split that
    bins the reference boxes clipped to each bin along the node's widest
    axis; a triangle straddling the chosen plane is referenced by both
    children, each with its box clipped at the plane. Spatial splits are
    only tried where the object split's children overlap (SA(L and R) /
    SA(root) > alpha) and the references stay under max_dup * T.

    `tri_order` may reference a triangle more than once: the triangle
    tables, the leaf packing, the collapse and the refit all gather by id.
    Duplicates add candidate tests and never change a closest or any hit."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.uint32)
    T = indices.shape[0]
    if T == 0:
        return _empty_build()
    tmin, tmax = triangle_aabbs(vertices, indices)

    max_refs = int(T * max_dup) + 64
    rtri = np.empty(max_refs, np.int64)        # reference -> triangle
    rmin = np.empty((max_refs, 3), np.float32)   # reference boxes, clipped
    rmax = np.empty((max_refs, 3), np.float32)
    rtri[:T] = np.arange(T)
    rmin[:T] = tmin
    rmax[:T] = tmax
    n_refs = T

    cap = 2 * max_refs + 2
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left = np.full(cap, LEAF, np.int32)
    right = np.full(cap, LEAF, np.int32)
    tri_start = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    out_order = np.empty(max_refs, np.int64)
    out_n = 0
    n_nodes = 1
    max_depth = 1
    root_sa = max(_area(tmin.min(0), tmax.max(0)), 1e-30)

    stack = [(0, np.arange(T, dtype=np.int64), 1)]   # (node, reference ids, depth)
    while stack:
        node, ids, depth = stack.pop()
        max_depth = max(max_depth, depth)
        bmin = rmin[ids].min(axis=0)
        bmax = rmax[ids].max(axis=0)
        node_min[node] = bmin
        node_max[node] = bmax
        count = ids.shape[0]
        if count <= leaf_size:
            tri_start[node] = out_n
            tri_count[node] = count
            out_order[out_n:out_n + count] = rtri[ids]
            out_n += count
            continue

        # ---- object split: binned SAH on the reference centroids ----
        cen = 0.5 * (rmin[ids] + rmax[ids])
        cmin, cmax = cen.min(axis=0), cen.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        obj_mask = None
        obj_cost = np.inf
        obj_overlap = np.inf
        if extent[axis] > 0.0:
            scale = bins * (1.0 - 1e-6) / extent[axis]
            b = np.clip(((cen[:, axis] - cmin[axis]) * scale).astype(np.int32), 0, bins - 1)
            bin_cnt = np.bincount(b, minlength=bins)
            bin_min = np.full((bins, 3), np.inf, np.float32)
            bin_max = np.full((bins, 3), -np.inf, np.float32)
            for a in range(3):
                np.minimum.at(bin_min[:, a], b, rmin[ids][:, a])
                np.maximum.at(bin_max[:, a], b, rmax[ids][:, a])
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            gmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            gmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_cnt)
            rcnt = count - lcnt
            cost = _areas(lmin, lmax)[:-1] * lcnt[:-1] + _areas(gmin[1:], gmax[1:]) * rcnt[:-1]
            cost = np.where((lcnt[:-1] == 0) | (rcnt[:-1] == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                obj_cost = float(cost[best])
                obj_mask = b <= best
                omn = np.maximum(lmin[best], gmin[best + 1])
                omx = np.minimum(lmax[best], gmax[best + 1])
                obj_overlap = _area(omn, omx) if (omx > omn).all() else 0.0

        # ---- spatial split: chopped binning along the node's widest axis,
        # tried only where the object split's children overlap and the
        # reference budget has room ----
        sp_cost = np.inf
        sp_plane = 0.0
        sp_axis = int(np.argmax(bmax - bmin))
        headroom = max_refs - n_refs - count
        if (headroom > 0 and (not np.isfinite(obj_cost) or obj_overlap / root_sa > alpha)
                and bmax[sp_axis] - bmin[sp_axis] > 0.0):
            ext = bmax[sp_axis] - bmin[sp_axis]
            inv = bins / ext
            lo = rmin[ids][:, sp_axis]
            hi = rmax[ids][:, sp_axis]
            eb = np.clip(((lo - bmin[sp_axis]) * inv).astype(np.int32), 0, bins - 1)
            xb = np.clip(((hi - bmin[sp_axis]) * inv - 1e-9).astype(np.int32), 0, bins - 1)
            xb = np.maximum(xb, eb)
            edges = bmin[sp_axis] + np.arange(bins + 1) * (ext / bins)
            sbin_min = np.full((bins, 3), np.inf, np.float32)
            sbin_max = np.full((bins, 3), -np.inf, np.float32)
            for bi in range(bins):
                m = (eb <= bi) & (xb >= bi)
                if not m.any():
                    continue
                cm = rmin[ids][m].copy()
                cM = rmax[ids][m].copy()
                cm[:, sp_axis] = np.maximum(cm[:, sp_axis], edges[bi])
                cM[:, sp_axis] = np.minimum(cM[:, sp_axis], edges[bi + 1])
                sbin_min[bi] = np.minimum(sbin_min[bi], cm.min(axis=0))
                sbin_max[bi] = np.maximum(sbin_max[bi], cM.max(axis=0))
            ecnt = np.bincount(eb, minlength=bins)
            xcnt = np.bincount(xb, minlength=bins)
            slmin = np.minimum.accumulate(sbin_min, axis=0)
            slmax = np.maximum.accumulate(sbin_max, axis=0)
            srmin = np.minimum.accumulate(sbin_min[::-1], axis=0)[::-1]
            srmax = np.maximum.accumulate(sbin_max[::-1], axis=0)[::-1]
            nl = np.cumsum(ecnt)              # references entering at or before bin i
            nr = count - np.cumsum(xcnt)      # references leaving after bin i
            scost = _areas(slmin, slmax)[:-1] * nl[:-1] + _areas(srmin[1:], srmax[1:]) * nr[:-1]
            dup = nl[:-1] + nr[:-1] - count   # straddling copies per plane
            scost = np.where((nl[:-1] == 0) | (nr[:-1] == 0) | (dup > headroom), np.inf, scost)
            sbest = int(np.argmin(scost))
            if np.isfinite(scost[sbest]):
                sp_cost = float(scost[sbest])
                sp_plane = float(edges[sbest + 1])

        # ---- the cheaper split ----
        if sp_cost < obj_cost:
            lo = rmin[ids][:, sp_axis]
            hi = rmax[ids][:, sp_axis]
            left_only = hi <= sp_plane
            # a reference flat on the plane (lo == hi == plane) goes left only:
            # in both children it would be one record clipped twice
            right_only = (lo >= sp_plane) & ~left_only
            strad = ~(left_only | right_only)
            n_l = int(left_only.sum() + strad.sum())
            n_r = int(right_only.sum() + strad.sum())
            if n_l == 0 or n_r == 0 or (n_l >= count and n_r >= count):
                # degenerate (every reference straddles: both children would
                # be the parent): a median split, decided before any clip
                lids, rids = ids[: count // 2], ids[count // 2:]
            else:
                sid = ids[strad]
                rmax[sid, sp_axis] = sp_plane          # the left keeps them, clipped
                k = sid.shape[0]
                new_ids = np.arange(n_refs, n_refs + k, dtype=np.int64)
                rtri[new_ids] = rtri[sid]              # the right gets clipped copies
                rmin[new_ids] = rmin[sid]
                rmin[new_ids, sp_axis] = sp_plane
                rmax[new_ids] = rmax[sid]
                rmax[new_ids, sp_axis] = hi[strad]     # `hi` was read before the clip
                n_refs += k
                lids = np.concatenate([ids[left_only], sid])
                rids = np.concatenate([ids[right_only], new_ids])
        elif obj_mask is not None:
            lids, rids = ids[obj_mask], ids[~obj_mask]
            if lids.size == 0 or rids.size == 0:
                lids, rids = ids[: count // 2], ids[count // 2:]
        else:
            lids, rids = ids[: count // 2], ids[count // 2:]

        l_idx, r_idx = n_nodes, n_nodes + 1
        n_nodes += 2
        if n_nodes > cap:
            raise RuntimeError("SBVH node capacity exceeded")
        left[node] = l_idx
        right[node] = r_idx
        stack.append((r_idx, rids, depth + 1))
        stack.append((l_idx, lids, depth + 1))

    return BvhBuildResult(node_min[:n_nodes].copy(), node_max[:n_nodes].copy(),
                          left[:n_nodes].copy(), right[:n_nodes].copy(),
                          tri_start[:n_nodes].copy(), tri_count[:n_nodes].copy(),
                          out_order[:out_n].copy(), max_depth)


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
