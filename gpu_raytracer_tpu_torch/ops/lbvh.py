"""On-device LBVH construction: Morton codes, a stable sort, a Karras (2012)
hierarchy, bottom-up boxes, threaded links and the even-depth BVH4 overlay.

Plain PyTorch on tensors of any device, so that a refit or rebuild of a
scene on the card never leaves it. Every function reproduces the JAX
package's `ops/lbvh.py`: the integer results are equal and the boxes are
the same values (min and max only). What differs is how loops end: JAX's
data-dependent `while_loop` becomes a fixed number of masked iterations
(reading a condition back would make the host wait for the device every
iteration), and unsigned 32-bit arithmetic is done in int64 under the same
masks.

Node layout: [2T-1] nodes, root 0, internal nodes 0..T-2, leaves T-1..2T-2
(leaf p covers sorted position p), as models/bvh.py::Bvh.
"""

from __future__ import annotations

import math

import torch

from ..models.bvh import Bvh

_BIG = 3.0e38    # the empty box: min at +BIG, max at -BIG
_FAR = 1e30      # an empty quad slot's inert point bounds
GROUP = 8        # triangles per leaf of the grouped build (8-slot rows)
MASK32 = 0xFFFFFFFF


def expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so they occupy every 3rd bit. The uint32
    products of the reference wrap modulo 2^32; each is masked to 32 bits
    at once, so computing them in int64 gives the same words."""
    v = v.to(torch.int64) & MASK32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes [T] int64 of [T,3] f32 centroids within lo/hi [3]."""
    x = torch.clamp((centroids - lo) / torch.clamp(hi - lo, min=1e-9), 0.0, 1.0)
    q = torch.clamp((x * 1024.0).to(torch.int64), max=1023)
    return (expand_bits_10(q[:, 0]) << 2) | (expand_bits_10(q[:, 1]) << 1) \
        | expand_bits_10(q[:, 2])


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int64 holding 0..2^32-1): SWAR sums."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & MASK32) >> 24


def _nlz32(v: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each 32-bit word (0 -> 32): smear the highest set
    bit down, then count the ones. int64 in, int64 out."""
    v = v.to(torch.int64) & MASK32
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    return 32 - _popcount32(v)


def _karras_from_codes(codes: torch.Tensor, leaf_min: torch.Tensor, leaf_max: torch.Tensor):
    """Karras hierarchy over L pre-sorted leaf codes [L] with boxes [L,3]
    -> (node_min, node_max, left, right, hit, miss) over 2L-1 nodes, int32
    links: internal nodes 0..L-2 (root 0), the leaf of sorted position p at
    L-1+p."""
    T = codes.shape[0]
    dev = codes.device
    n_internal = T - 1
    n_nodes = 2 * T - 1
    n_steps = max(int(math.ceil(math.log2(max(T, 2)))) + 2, 2)
    sweeps = min(max(4 * n_steps, 8), 128)

    def delta(i, j):
        """Common-prefix length of sorted codes i and j, index bits breaking
        ties between equal codes; -1 out of range."""
        valid = (j >= 0) & (j < T)
        cj = codes[torch.clamp(j, 0, T - 1)]
        x = codes[i] ^ cj
        d = torch.where(x == 0, 32 + _nlz32((i ^ j) & MASK32), _nlz32(x))
        return torch.where(valid, d, torch.full_like(d, -1))

    i = torch.arange(n_internal, dtype=torch.int64, device=dev)
    one = torch.ones_like(i)

    # direction and the minimum prefix just outside the range
    d = torch.where(delta(i, i + 1) >= delta(i, i - 1), one, -one)
    delta_min = delta(i, i - d)

    # upper bound of the range length by galloping. The reference loops while
    # some lane grew and max(lmax) < 2T. A lane grows only while i + nxt * d
    # is in range (delta is -1 outside, never above delta_min), so lmax < T
    # always and the second clause never ends the loop; a lane that did not
    # grow tests the same probe again and never grows later. So a fixed
    # ceil(log2 2T) + 1 iterations (more than the growths any lane can make,
    # plus the one that finds none) give the reference's lmax without reading
    # a condition back from the device.
    lmax = torch.full_like(i, 2)
    for _ in range(int(math.ceil(math.log2(2 * max(T, 1)))) + 1):
        nxt = lmax * 2
        lmax = torch.where(delta(i, i + nxt * d) > delta_min, nxt, lmax)
    lmax = lmax * 2

    # binary search for the exact length l (the reference's n_steps + 2 steps)
    l, step = torch.zeros_like(i), lmax
    for _ in range(n_steps + 2):
        step = torch.clamp(step // 2, min=1)
        ok = delta(i, i + (l + step) * d) > delta_min
        l = torch.where(ok, l + step, l)
    j = i + l * d
    delta_node = delta(i, j)

    # binary search for the split point gamma
    s, step = i, l
    for _ in range(n_steps + 2):
        step = (step + 1) // 2
        probe = s + step * d
        ok = (torch.abs(probe - i) < l) & (delta(i, probe) > delta_node)
        s = torch.where(ok, probe, s)
        step = torch.clamp(step, min=1)
    gamma = torch.minimum(s, s + d)

    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    left_child = torch.where(first == gamma, n_internal + gamma, gamma)
    right_child = torch.where(last == gamma + 1, n_internal + gamma + 1, gamma + 1)

    none = torch.full((T,), -1, dtype=torch.int64, device=dev)
    left = torch.cat([left_child, none])
    right = torch.cat([right_child, none])
    parent = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    parent.index_copy_(0, left_child, i)
    parent.index_copy_(0, right_child, i)

    # bottom-up boxes: every sweep recomputes all internal nodes from the
    # previous sweep's children; `sweeps` exceeds the tree's depth
    node_min = torch.cat([torch.full((n_internal, 3), _BIG, device=dev), leaf_min])
    node_max = torch.cat([torch.full((n_internal, 3), -_BIG, device=dev), leaf_max])
    for _ in range(sweeps):
        new_min = torch.minimum(node_min[left_child], node_min[right_child])
        new_max = torch.maximum(node_max[left_child], node_max[right_child])
        node_min[:n_internal] = new_min
        node_max[:n_internal] = new_max

    # threaded links: a left child's miss is its sibling; a right child
    # inherits its parent's, resolved by pulling along the parent chain
    is_left = torch.zeros((n_nodes,), dtype=torch.bool, device=dev).index_fill_(
        0, left_child, True)
    sibling = torch.zeros((n_nodes,), dtype=torch.int64, device=dev)
    sibling.index_copy_(0, left_child, right_child)
    miss = torch.where(is_left, sibling, torch.full_like(sibling, -2))
    miss[:1].fill_(-1)   # a fill, not `miss[0] = -1`: that copies a host scalar, a sync
    has_parent = parent >= 0
    for _ in range(sweeps):
        fill = torch.where(has_parent, miss[torch.clamp(parent, min=0)],
                           torch.full_like(miss, -1))
        miss = torch.where((miss == -2) & (fill != -2), fill, miss)
    miss = torch.where(miss == -2, torch.full_like(miss, -1), miss)
    hit = torch.where(left >= 0, left, miss)
    i32 = lambda a: a.to(torch.int32)
    return node_min, node_max, i32(left), i32(right), i32(hit), i32(miss)


def _sorted_codes(tri_min: torch.Tensor, tri_max: torch.Tensor):
    """Morton codes of the boxes' centres in the scene's bounds, and the
    stable order that sorts them (equal codes keep their triangle order,
    as JAX's stable argsort does)."""
    cent = 0.5 * (tri_min + tri_max)
    lo = tri_min.amin(dim=0)
    hi = tri_max.amax(dim=0)
    codes = morton_codes(cent, lo, hi)
    return codes, torch.argsort(codes, stable=True)


def build_lbvh_arrays(tri_min: torch.Tensor, tri_max: torch.Tensor):
    """LBVH from per-triangle boxes [T,3] / [T,3], T >= 2, one triangle per
    leaf -> (node_min, node_max, left, right, tri_start, tri_count,
    hit_link, miss_link, order): nodes [2T-1]; `order` [T] int32 maps a
    sorted leaf position to the original triangle."""
    T = tri_min.shape[0]
    dev = tri_min.device
    codes, order = _sorted_codes(tri_min, tri_max)
    node_min, node_max, left, right, hit, miss = _karras_from_codes(
        codes[order], tri_min[order], tri_max[order])
    zeros = torch.zeros((T - 1,), dtype=torch.int32, device=dev)
    tri_start = torch.cat([zeros, torch.arange(T, dtype=torch.int32, device=dev)])
    tri_count = torch.cat([zeros, torch.ones((T,), dtype=torch.int32, device=dev)])
    return (node_min, node_max, left, right, tri_start, tri_count, hit, miss,
            order.to(torch.int32))


def build_lbvh_grouped_arrays(tri_min: torch.Tensor, tri_max: torch.Tensor):
    """LBVH with aligned 8-triangle leaves: the Karras tree is built over
    groups of 8 Morton-consecutive triangles (group g's leaf covers sorted
    positions [8g, 8g+8), the tail padded with degenerate slots; its box is
    the members' union, its code its first member's). Returns the tuple of
    `build_lbvh_arrays` over 2G-1 nodes, G = ceil(T/8); leaf g has
    tri_start 8g and tri_count 8."""
    T = tri_min.shape[0]
    dev = tri_min.device
    G = -(-T // GROUP)
    pad = G * GROUP - T
    codes, order = _sorted_codes(tri_min, tri_max)
    smin, smax = tri_min[order], tri_max[order]
    if pad:
        smin = torch.cat([smin, torch.full((pad, 3), _BIG, device=dev)])
        smax = torch.cat([smax, torch.full((pad, 3), -_BIG, device=dev)])
    gmin = smin.reshape(G, GROUP, 3).amin(dim=1)
    gmax = smax.reshape(G, GROUP, 3).amax(dim=1)
    order32 = order.to(torch.int32)
    if G == 1:
        none = torch.full((1,), -1, dtype=torch.int32, device=dev)
        return (gmin, gmax, none, none.clone(), torch.zeros((1,), dtype=torch.int32, device=dev),
                torch.full((1,), GROUP, dtype=torch.int32, device=dev), none.clone(),
                none.clone(), order32)
    gcodes = codes[order][::GROUP]     # a group starts on a real triangle
    node_min, node_max, left, right, hit, miss = _karras_from_codes(gcodes, gmin, gmax)
    zeros = torch.zeros((G - 1,), dtype=torch.int32, device=dev)
    tri_start = torch.cat([zeros, torch.arange(G, dtype=torch.int32, device=dev) * GROUP])
    tri_count = torch.cat([zeros, torch.full((G,), GROUP, dtype=torch.int32, device=dev)])
    return node_min, node_max, left, right, tri_start, tri_count, hit, miss, order32


# the 4-input sorting network of the overlay's children; tie order decides
# the visiting order, and with it which of two equal-t triangles wins
_SORT4 = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


def collapse4_device(node_min, node_max, left, right, tri_start, tri_count):
    """Even-depth BVH4 overlay of a Karras binary tree -> (q_child, q_leafc,
    q_min, q_max, q_axis, q_src), shapes [I,4] / [I,4,3] / [I].

    Every internal binary node b emits a quad record whose children are b's
    grandchildren (or a child itself where that child is a leaf). From the
    root a traversal reaches exactly the even-depth internal nodes; the
    odd-depth records are computed too (static shapes) and never reached.
    Quad ids are binary internal ids, with no compaction. Children are
    sorted by centroid along the parent's longest axis (strict >, so equal
    keys keep their slot order); empty slots get child -1, count 0 and FAR
    point bounds. q_src is the binary node behind each slot (-1 empty), for
    topology refits. Needs >= 1 internal node."""
    n_nodes = left.shape[0]
    I = (n_nodes + 1) // 2 - 1
    left, right = left.long(), right.long()
    is_leaf = left < 0

    def side_slots(c):
        expand = ~is_leaf[c]
        return (torch.where(expand, left[c], c),
                torch.where(expand, right[c], torch.full_like(c, -1)))

    s0, s1 = side_slots(left[:I])
    s2, s3 = side_slots(right[:I])
    slots = torch.stack([s0, s1, s2, s3], dim=1)             # [I,4]
    valid = slots >= 0
    sc = torch.where(valid, slots, torch.zeros_like(slots))
    slot_leaf = valid & is_leaf[sc]
    none = torch.full_like(slots, -1)
    q_child = torch.where(valid, torch.where(slot_leaf, tri_start.long()[sc], sc), none)
    q_leafc = torch.where(slot_leaf, tri_count.long()[sc], torch.zeros_like(slots))
    far = torch.full((I, 4, 3), _FAR, device=node_min.device)
    q_min = torch.where(valid[..., None], node_min[sc], far)
    q_max = torch.where(valid[..., None], node_max[sc], far)

    q_axis = torch.argmax(node_max[:I] - node_min[:I], dim=1)   # first of equal extents
    cent = q_min + q_max                                        # 2x centroid
    key = cent.gather(2, q_axis[:, None, None].expand(I, 4, 1))[..., 0]
    key = torch.where(valid, key, torch.full_like(key, 3e38))

    arrs = [key, q_child, q_leafc, q_min, q_max, torch.where(valid, slots, none)]
    for i, j in _SORT4:
        swap = key[:, i] > key[:, j]
        for a in arrs:
            s = swap.view(-1, *([1] * (a.dim() - 2)))
            ai, aj = torch.where(s, a[:, j], a[:, i]), torch.where(s, a[:, i], a[:, j])
            a[:, i] = ai
            a[:, j] = aj
    _, q_child, q_leafc, q_min, q_max, q_src = arrs
    i32 = lambda a: a.to(torch.int32)
    return i32(q_child), i32(q_leafc), q_min, q_max, i32(q_axis), i32(q_src)


def lbvh_from_mesh_device(vertices: torch.Tensor, indices: torch.Tensor,
                          material_id: torch.Tensor, group: int = 1):
    """Mesh tensors -> (Bvh, tri_v0, tri_e1, tri_e2, tri_mat) in sorted-leaf
    order on the mesh's device. group=1: one triangle per leaf; group=8:
    aligned 8-slot leaves, the triangle arrays padded to 8 * ceil(T/8) with
    degenerate slots (zero edges never hit)."""
    idx = indices.long()
    a, b, c = vertices[idx[:, 0]], vertices[idx[:, 1]], vertices[idx[:, 2]]
    tri_min = torch.minimum(a, torch.minimum(b, c))
    tri_max = torch.maximum(a, torch.maximum(b, c))
    build = build_lbvh_arrays if group == 1 else build_lbvh_grouped_arrays
    nmin, nmax, left, right, tri_start, tri_count, hit, miss, order = build(tri_min, tri_max)
    bvh = Bvh(node_min=nmin, node_max=nmax, left=left, right=right, tri_start=tri_start,
              tri_count=tri_count, hit_link=hit, miss_link=miss, leaf_align=group,
              max_leaf=group)
    o = order.long()
    v0 = a[o]
    e1 = b[o] - v0
    e2 = c[o] - v0
    mat = material_id.to(torch.int32)[o]
    pad = (-v0.shape[0]) % group
    if pad:
        z = v0.new_zeros((pad, 3))
        v0, e1, e2 = torch.cat([v0, z]), torch.cat([e1, z]), torch.cat([e2, z])
        mat = torch.cat([mat, mat.new_zeros((pad,))])
    return bvh, v0, e1, e2, mat
