"""The benchmark's own bounding-volume hierarchy and its plain walk.

`build` makes the tree a configuration states (its `bvh_width` and
`bvh_leaf_size`, split by the surface-area heuristic), independently of the
program: a binary tree split by the SAH over BINS centroid bins per axis
(NumPy, all nodes of a level at once), down to leaves of at most `leaf`
triangles, then collapsed to nodes of `width` children (each node takes in
its inner child of largest surface area until it holds `width`).
`walk` traces rays through it in plain PyTorch on any device, closest hit or
any hit, with the program's Möller-Trumbore test, and counts the work: inner
nodes visited, child boxes tested (a node's live slots) and triangles tested.
The reference (reference.py) takes its hits from it, and the rooflines
(roofline.py) take their operation counts from its counts, so both stay the
same whatever walk, layout or kernel the program uses.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

BINS = 16                      # centroid bins per axis of the SAH split
MIN_T = float(np.float32(1e-5))   # the program's RaytracerConfig.min_ray_distance as f32


@dataclass
class Tree:
    lo: torch.Tensor           # [Nn,3] node boxes
    hi: torch.Tensor
    child: torch.Tensor        # [Nn,width] i64 child nodes, -1 for an empty slot
    start: torch.Tensor        # [Nn] i64 first triangle of a leaf (leaf order)
    count: torch.Tensor        # [Nn] i64 triangles of a leaf, 0 inside
    v0: torch.Tensor           # [T,3] triangles in leaf order
    e1: torch.Tensor
    e2: torch.Tensor
    tri: torch.Tensor          # [T] i64 original triangle id of each leaf slot
    depth: int                 # levels of inner nodes on the longest path
    leaf: int                  # triangles a leaf holds at most

    @property
    def nodes(self) -> int:
        return int(self.child.shape[0])

    def to(self, device, dtype=None) -> "Tree":
        """The tree on `device`, its boxes and triangles in `dtype` (as they
        are, if None)."""
        out = {}
        for f in fields(self):
            x = getattr(self, f.name)
            if isinstance(x, torch.Tensor):
                x = x.to(device)
                if dtype is not None and x.is_floating_point():
                    x = x.to(dtype)
            out[f.name] = x
        return Tree(**out)

    def table_bytes(self) -> int:
        """Bytes of the tree and its triangles as a walk needs them: an inner
        node's slots, each a child box (24), a link (4) and a count (4), a
        triangle's v0, e1, e2 (36)."""
        inner = int((self.count == 0).sum())
        return inner * int(self.child.shape[1]) * 32 + int(self.v0.shape[0]) * 36


def _area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def _split_level(b, e, order, tmin, tmax, cen):
    """The SAH split of every node [b, e) of a level at once: reorders
    `order` within each node -> the number of triangles of each left child."""
    lens = e - b
    K = lens.shape[0]
    offs = np.cumsum(lens) - lens
    n = int(lens.sum())
    seg = np.repeat(np.arange(K), lens)
    idx = np.repeat(b - offs, lens) + np.arange(n)
    tri = order[idx]
    c, lo_t, hi_t = cen[tri], tmin[tri], tmax[tri]
    cmin = np.minimum.reduceat(c, offs, axis=0)
    ext = np.maximum.reduceat(c, offs, axis=0) - cmin
    best = np.full(K, np.inf)
    best_axis = np.zeros(K, np.int64)
    best_bin = np.zeros(K, np.int64)
    bins = []
    for a in range(3):
        scale = np.where(ext[:, a] > 0, BINS / np.where(ext[:, a] > 0, ext[:, a], 1.0), 0.0)
        bi = np.minimum(((c[:, a] - cmin[seg, a]) * scale[seg]).astype(np.int64), BINS - 1)
        bins.append(bi)
        key = seg * BINS + bi
        cnt = np.bincount(key, minlength=K * BINS).reshape(K, BINS)
        blo = np.full((K * BINS, 3), np.inf, np.float32)
        bhi = np.full((K * BINS, 3), -np.inf, np.float32)
        by = np.argsort(key, kind="stable")
        ks = key[by]
        runs = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        blo[ks[runs]] = np.minimum.reduceat(lo_t[by], runs, axis=0)
        bhi[ks[runs]] = np.maximum.reduceat(hi_t[by], runs, axis=0)
        blo, bhi = blo.reshape(K, BINS, 3), bhi.reshape(K, BINS, 3)
        lc = np.cumsum(cnt, axis=1)[:, :-1]
        rc = np.cumsum(cnt[:, ::-1], axis=1)[:, ::-1][:, 1:]
        la = _area(np.minimum.accumulate(blo, axis=1), np.maximum.accumulate(bhi, axis=1))
        ra = _area(np.minimum.accumulate(blo[:, ::-1], axis=1)[:, ::-1],
                   np.maximum.accumulate(bhi[:, ::-1], axis=1)[:, ::-1])
        cost = np.where((lc > 0) & (rc > 0), la[:, :-1] * lc + ra[:, 1:] * rc, np.inf)
        j = cost.argmin(axis=1)
        cj = cost[np.arange(K), j]
        better = cj < best
        best[better], best_axis[better], best_bin[better] = cj[better], a, j[better]
    side = np.stack(bins)[best_axis[seg], np.arange(n)] > best_bin[seg]
    # a node whose centroids all coincide has no split by bins: halve it
    pos = np.arange(n) - offs[seg]
    side = np.where(np.isfinite(best)[seg], side, pos >= lens[seg] // 2)
    perm = np.argsort(seg * 2 + side, kind="stable")
    order[idx] = tri[perm]
    return np.bincount(seg, weights=~side, minlength=K).astype(np.int64)


def _binary(tmin, tmax, leaf: int):
    """The binary SAH tree -> (order, begin, end, left, right, level) with
    nodes in level order (children after their parents)."""
    cen = (tmin + tmax) * 0.5
    T = tmin.shape[0]
    order = np.arange(T)
    begin, end = [np.array([0])], [np.array([T])]
    left, right, level = [np.array([-1])], [np.array([-1])], [np.array([0])]
    nodes, frontier, depth = 1, np.array([0]), 0
    while frontier.size:
        b, e = np.concatenate(begin)[frontier], np.concatenate(end)[frontier]
        big = e - b > leaf
        frontier, b, e = frontier[big], b[big], e[big]
        if not frontier.size:
            break
        nl = _split_level(b, e, order, tmin, tmax, cen)
        K = frontier.size
        kids = nodes + np.arange(2 * K)
        lft, rgt = kids[0::2], kids[1::2]
        L, R = np.concatenate(left), np.concatenate(right)
        L[frontier], R[frontier] = lft, rgt
        depth += 1
        left, right = [L, np.full(2 * K, -1)], [R, np.full(2 * K, -1)]
        begin.append(np.stack([b, b + nl], 1).ravel())
        end.append(np.stack([b + nl, e], 1).ravel())
        level.append(np.full(2 * K, depth))
        nodes += 2 * K
        frontier = kids
    cat = lambda xs: np.concatenate(xs)
    return order, cat(begin), cat(end), cat(left), cat(right), cat(level)


def build(vertices: np.ndarray, faces: np.ndarray, width: int = 4, leaf: int = 8) -> Tree:
    """The SAH tree of `width` over triangles (vertices [V,3] f32, faces
    [T,3]), leaves of at most `leaf`; e1 = v1 - v0 and e2 = v2 - v0 in the
    faces' own corner order."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    tv = v[f]                                          # [T,3,3]
    tmin, tmax = tv.min(axis=1), tv.max(axis=1)
    order, begin, end, left, right, level = _binary(tmin, tmax, leaf)
    # binary boxes: leaves from their triangles, inner nodes level by level upwards
    N = left.shape[0]
    lo = np.zeros((N, 3), np.float32)
    hi = np.zeros((N, 3), np.float32)
    leaves = np.flatnonzero(left < 0)
    leaves = leaves[np.argsort(begin[leaves])]
    lo[leaves] = np.minimum.reduceat(tmin[order], begin[leaves], axis=0)
    hi[leaves] = np.maximum.reduceat(tmax[order], begin[leaves], axis=0)
    for lv in range(int(level.max()), -1, -1):
        at = np.flatnonzero((level == lv) & (left >= 0))
        lo[at] = np.minimum(lo[left[at]], lo[right[at]])
        hi[at] = np.maximum(hi[left[at]], hi[right[at]])
    area = _area(lo, hi)
    # collapse: each wide node takes in its largest inner child until it holds `width`
    wide_of = {0: 0}
    kids, queue, head = [], [0], 0
    while head < len(queue):
        bn = queue[head]
        head += 1
        if left[bn] < 0:
            kids.append([])
            continue
        slots = [int(left[bn]), int(right[bn])]
        while len(slots) < width:
            inner = [s for s in slots if left[s] >= 0]
            if not inner:
                break
            s = max(inner, key=lambda x: area[x])
            k = slots.index(s)
            slots[k:k + 1] = [int(left[s]), int(right[s])]
        for s in slots:
            wide_of[s] = len(queue)
            queue.append(s)
        kids.append([wide_of[s] for s in slots])
    src = np.asarray(queue)
    child = np.full((len(queue), width), -1, np.int64)
    for i, ks in enumerate(kids):
        child[i, :len(ks)] = ks
    is_leaf = left[src] < 0
    wdepth = np.zeros(len(queue), np.int64)
    for i in range(len(queue) - 1, -1, -1):           # children come after their parent
        if not is_leaf[i]:
            wdepth[i] = 1 + max(wdepth[k] for k in kids[i])
    fo = f[order]
    v0 = v[fo[:, 0]]
    t = torch.from_numpy
    return Tree(t(lo[src]), t(hi[src]), t(child), t(begin[src]),
                t(np.where(is_leaf, end[src] - begin[src], 0)), t(v0),
                t(v[fo[:, 1]] - v0), t(v[fo[:, 2]] - v0), t(order.copy()), int(wdepth[0]), leaf)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def triangle_test(o, d, v0, e1, e2, max_t):
    """Möller-Trumbore as the program states it (ops/intersect.py): the hit
    distance, or +inf on a miss, for rays o, d against triangles, all [...,3]
    broadcast together, below max_t."""
    h = _cross(d, e2)
    a = _dot(e1, h)
    f = torch.reciprocal(a)
    s = o - v0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    hit = ((torch.abs(a) >= MIN_T) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > MIN_T) & (t < max_t))
    return torch.where(hit, t, torch.full_like(t, float("inf")))


@dataclass
class WalkResult:
    t: torch.Tensor            # [R] f32, +inf on a miss
    tri: torch.Tensor          # [R] i64 original triangle id, -1 on a miss
    inner: int                 # inner nodes visited
    slots: int                 # child boxes tested (the visited nodes' live slots)
    tests: int                 # triangle tests


def walk(tree: Tree, o: torch.Tensor, d: torch.Tensor, max_t: torch.Tensor,
         any_hit: bool = False) -> WalkResult:
    """Trace rays o, d [R,3] below max_t [R] through `tree` (on the rays'
    device): the nearest hit (of equal distances, the first found), or with
    `any_hit` the first found. A node's children are visited near first, and
    a box is entered only if it starts before the ray's best distance so far."""
    dev = o.device
    R = o.shape[0]
    best = torch.where(max_t > 0, max_t, torch.zeros_like(max_t)).to(o.dtype)
    best_slot = torch.full((R,), -1, dtype=torch.int64, device=dev)
    big = torch.finfo(d.dtype).max
    inv = torch.clamp(torch.reciprocal(d), -big, big)
    width, leaf = int(tree.child.shape[1]), tree.leaf
    stack = torch.zeros((R, (width - 1) * tree.depth + 2), dtype=torch.int64, device=dev)
    sp = torch.ones((R,), dtype=torch.int64, device=dev)
    lane = torch.arange(leaf, device=dev)
    inner = slots = tests = 0
    ids = torch.nonzero(max_t > 0)[:, 0]
    sp[max_t <= 0] = 0

    def box(rays, node):
        """Boxes `node` ([k] or [k,width]) against the rays `rays` [k]."""
        extra = (slice(None),) + (None,) * (node.dim() - 1)
        org, iv = o[rays][extra], inv[rays][extra]
        t0 = (tree.lo[node] - org) * iv
        t1 = (tree.hi[node] - org) * iv
        near = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=0.0)
        far = torch.maximum(t0, t1).amin(dim=-1)
        return near, (near <= far) & (near < best[rays][extra])

    # the root's own box
    if ids.numel():
        _, ok = box(ids, torch.zeros_like(ids))
        sp[ids[~ok]] = 0
        ids = ids[ok]
    while ids.numel():
        top = sp[ids] - 1
        node = stack[ids, top]
        sp[ids] = top
        is_leaf = tree.count[node] > 0
        # inner nodes: every live child's box, the nearest pushed last
        ri, ni = ids[~is_leaf], node[~is_leaf]
        if ri.numel():
            inner += int(ri.numel())
            ch = tree.child[ni]
            live = ch >= 0
            slots += int(live.sum())
            ch = torch.clamp(ch, min=0)
            near, ok = box(ri, ch)
            ok &= live
            key = torch.where(ok, near, torch.full_like(near, float("inf")))
            _, far_first = torch.sort(key, dim=1, descending=True, stable=True)
            ch, ok = ch.gather(1, far_first), ok.gather(1, far_first)
            for k in range(width):
                r = ri[ok[:, k]]
                stack[r, sp[r]] = ch[ok[:, k], k]
                sp[r] += 1
        # leaves: up to `leaf` triangles at once
        rl, nl = ids[is_leaf], node[is_leaf]
        if rl.numel():
            cnt = tree.count[nl]
            tests += int(cnt.sum())
            slot = tree.start[nl][:, None] + lane[None, :]
            valid = lane[None, :] < cnt[:, None]
            slot = torch.where(valid, slot, torch.zeros_like(slot))
            t = triangle_test(o[rl][:, None, :], d[rl][:, None, :], tree.v0[slot],
                              tree.e1[slot], tree.e2[slot], best[rl][:, None])
            t = torch.where(valid, t, torch.full_like(t, float("inf")))
            tmin, k = t.min(dim=1)
            # min's index on ties is not promised: take the first explicitly
            k = torch.where(t == tmin[:, None], lane[None, :], leaf).amin(dim=1)
            won = torch.isfinite(tmin) & (tmin < best[rl])
            rw = rl[won]
            best[rw] = tmin[won]
            best_slot[rw] = slot[won, k[won]]
            if any_hit:
                sp[rw] = 0
        ids = ids[sp[ids] > 0]
    hit = best_slot >= 0
    t = torch.where(hit, best, torch.full_like(best, float("inf")))
    tri = torch.where(hit, tree.tri[torch.clamp(best_slot, min=0)], best_slot)
    return WalkResult(t, tri, inner, slots, tests)
