"""Plain BVH traversal over the threaded hit/miss links.

Every ray walks the binary tree in the reference's left-first DFS order:
on an AABB hit it continues at `hit_link` (left child, or the next subtree
after a leaf), on a miss at `miss_link`, and a leaf tests its triangle range
with strict-< closest-hit updates, so at equal t the earlier triangle in
leaf order wins. This is the plain version the CUDA traversal kernel is
held against; it runs on any device.

It is a masked loop over the active rays: each step gathers the node of
every ray still walking, tests the boxes, tests the leaves that were hit
(all slots of a leaf at once) and drops the rays whose walk has ended.
"""

from __future__ import annotations

import torch

from ..models.bvh import Bvh
from .intersect import MISS_T, triangle_hit_pairwise


def leaf_closest(orig, dirn, best_t, first, count, leaf_size, tri_v0, tri_e1, tri_e2):
    """Test up to `leaf_size` consecutive triangles from `first` (count per
    ray) -> (t, slot, hit) of the first-occurring closest hit below best_t."""
    k = torch.arange(leaf_size, device=orig.device)
    idx = torch.clamp(first[:, None] + k, 0, tri_v0.shape[0] - 1)    # [L,K]
    t, ok = triangle_hit_pairwise(orig[:, None, :], dirn[:, None, :],
                                  tri_v0[idx], tri_e1[idx], tri_e2[idx],
                                  best_t[:, None])
    ok = ok & (k < count[:, None])
    t = torch.where(ok, t, torch.full_like(t, MISS_T))
    tmin = t.amin(dim=1)
    win = torch.where(ok & (t == tmin[:, None]), k, leaf_size).amin(dim=1)
    hit = ok.any(dim=1)
    slot = idx.gather(1, torch.clamp(win, max=leaf_size - 1)[:, None])[:, 0]
    return tmin, slot, hit


def bvh_traverse_threaded(bvh: Bvh, tri_v0, tri_e1, tri_e2, orig, dirn, max_t,
                          leaf_size: int = 8, any_hit: bool = False,
                          work: torch.Tensor | None = None):
    """Closest-hit (or any-hit) for a ray batch orig/dirn [N,3], max_t [N]
    -> (best_t [N] with MISS_T on a miss, best_tri [N] leaf-order slot or
    -1, hit [N]). any_hit stops each ray at its first accepted leaf (the
    closest slot of that leaf). `work` [N,2] int64, if given, gets each
    ray's node visits (box tests) and triangle tests added."""
    N = orig.shape[0]
    dev = orig.device
    best_t = max_t.clone()
    best_tri = torch.full((N,), -1, dtype=torch.int64, device=dev)
    hit_link = bvh.hit_link.long()
    miss_link = bvh.miss_link.long()
    tri_start = bvh.tri_start.long()
    tri_count = bvh.tri_count.long()
    is_leaf = bvh.left < 0
    inv_d = torch.reciprocal(dirn)

    ray = torch.arange(N, device=dev)
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    for _ in range(bvh.num_nodes + 4):
        if ray.numel() == 0:
            break
        o = orig[ray]
        inv = inv_d[ray]
        t1 = (bvh.node_min[node] - o) * inv
        t2 = (bvh.node_max[node] - o) * inv
        tmin = torch.minimum(t1, t2).amax(dim=1)
        tmax = torch.maximum(t1, t2).amin(dim=1)
        box = (tmax >= 0.0) & (tmin <= tmax) & (tmin <= best_t[ray])
        leaf = torch.nonzero(box & is_leaf[node]).squeeze(1)
        if work is not None:
            work[:, 0].index_add_(0, ray, torch.ones_like(ray))
        if leaf.numel():
            r = ray[leaf]
            n = node[leaf]
            if work is not None:
                work[:, 1].index_add_(0, r, tri_count[n])
            t, slot, hit = leaf_closest(orig[r], dirn[r], best_t[r], tri_start[n],
                                        tri_count[n], leaf_size, tri_v0, tri_e1, tri_e2)
            best_t[r] = torch.where(hit, t, best_t[r])
            best_tri[r] = torch.where(hit, slot, best_tri[r])
        nxt = torch.where(box, hit_link[node], miss_link[node])
        keep = nxt >= 0
        if any_hit:
            keep &= best_tri[ray] < 0
        ray = ray[keep]
        node = nxt[keep]
    hit = best_tri >= 0
    return torch.where(hit, best_t, torch.full_like(best_t, MISS_T)), best_tri, hit
