// K1 unordered's walk (traverse_threaded.cu): the stackless left-first walk
// over the binary BVH's threaded hit and miss links of one ray, closest hit
// or any hit. Kept apart from the kernel and its launch so that the same
// function also compiles for the host (tests/test_torch_threaded_host.py
// builds it with g++ over stand-ins for the CUDA names and holds it to the
// plain walk bit for bit).
//
// The tables (ops/cuda/traverse.py::pack_threaded_tables):
//   nodes: one binary node per 32 bytes, 32-byte aligned, so that a visit
//          reads one sector with two 16-byte loads: (min.x, min.y, min.z,
//          max.x), (max.y, max.z, enter, miss), the links as int32 bits.
//          `enter` is where a hit box leads: the left child (>= 1) of an
//          internal node, or, for a leaf, its leaf code -1 - (first slot << 4
//          | count) (< 0; traverse.cuh's wide records code their leaves the
//          same way). A leaf's hit link is its miss link (models/bvh.py), so
//          after its test the walk goes on at `miss`; -1 ends the walk;
//   tris:  K1's triangle rows (traverse.cuh leaf_test).
//
// Semantics are ops/bvh_traverse.py::bvh_traverse_threaded's, bit for bit
// on t, slot and hit (built -fmad=false, IEEE division): the unclamped box
// test tmax >= 0 && tmin <= tmax && tmin <= best_t with NaN slabs
// rejecting (as torch.minimum / amax propagate NaN), a hit box leads to
// `enter` and a missed one to `miss`, a leaf's slots go through
// leaf_test's strict-< closest update in the left-first order, so the same
// winner on equal t; in any-hit mode a ray finishes the leaf it found a
// blocker in (the closest slot of that leaf) and stops.
//
// What bounds it on an H100: the work of the walk, not bytes. Left-first
// order culls only at best_t, so a camera ray of the 100k-triangle courtyard
// visits ~105 binary nodes and tests ~32 triangles (chip_smoke.py phase 24
// counts them with the plain walk): dependent loads from the L2-resident
// table, a few dozen instructions each, and lanes that part. What the
// design does about it, each choice read on an NVIDIA H100 80GB HBM3
// (PERF.md, chip_ab.py --threaded):
//   * a 32-byte record: a visit reads one sector, and a leaf's slot range
//     comes with its links (the 48-byte record before it, whose third
//     float4 held the range, read slower in this walk with the range read
//     for each hit leaf; PERF.md);
//   * the lean box test for tame rays (traverse.cuh is_tame) on tables whose
//     box planes hold no NaN, which the packer reads back (`lean`): no slab
//     product can then be NaN, so the six NaN tests of a visit fall away
//     with the same result. The near and far planes stay min and max of the
//     two plane distances: in this record an axis' two planes are in
//     different registers, so picking them by the direction's sign, as the
//     wide walk does by address, would cost the same six selects. The
//     choice is made once per ray;
//   * closest hit: the leaf tests taken out of the node loop and postponed
//     (Aila and Laine 2009, "Understanding the efficiency of ray traversal
//     on GPUs"): the warp runs the node loop until every lane still walking
//     holds a hit leaf, then the leaf tests together. A lane that holds one walks on
//     meanwhile, and stops at its next hit leaf, which it visits again after
//     the first one's test. The loops' conditions are warp votes over the
//     lanes that entered the walk (`warp`), so every one of those lanes
//     takes part in every vote, a lane whose walk has ended idling through
//     the rest. Why the winners stay the same: the leaves are tested in the
//     ray's own order, and a leaf is pended only while none is, so against
//     the best_t the plain walk has there; the boxes passed against a stale
//     (larger) best_t meanwhile only lead into subtrees whose boxes lie
//     inside theirs, so each of their leaves' entry is at least that of the
//     box the plain walk culled, and the visit again rejects it. That needs
//     every child box inside its parent's, which the packer checks (it
//     refuses a tree where one is not). The COUNT instance also counts, for
//     each ray, the visits it made with a leaf pending (`past`), which the
//     plain walk never makes;
//   * any hit: each leaf tested in the node loop as its box passes, and the
//     walk stops at the first blocking one. Shadow rays are short (~46
//     visits, ~8 triangle tests) and few of them walk past a leaf, so the
//     votes cost more than postponing gains (PERF.md).
// The visits a ray makes grow with postponing (the stale boxes' subtrees,
// the second leaf's visit again), so the step bound is twice the plain
// walk's (n_nodes + 4), which a valid tree never reaches.
#pragma once

#include <cuda_runtime.h>

#include "traverse.cuh"

namespace rt {

// The launch: threads per block, and the minimum resident blocks per SM
// that ptxas fits the registers to (1: no cap).
constexpr int kThreadedBlock = 128;
constexpr int kThreadedMinBlocks = 1;

// Whether the ray hits the box of record (a, b) at or before best_t; LEAN:
// without the NaN tests (a tame ray on NaN-free planes).
template <bool LEAN>
__device__ __forceinline__ bool threaded_box(const float4& a, const float4& b, const Ray& r,
                                             float best_t) {
  const float t1x = (a.x - r.ox) * r.ix;
  const float t1y = (a.y - r.oy) * r.iy;
  const float t1z = (a.z - r.oz) * r.iz;
  const float t2x = (a.w - r.ox) * r.ix;
  const float t2y = (b.x - r.oy) * r.iy;
  const float t2z = (b.y - r.oz) * r.iz;
  const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  const bool box = tmax >= 0.0f && tmin <= tmax && tmin <= best_t;
  if constexpr (LEAN) return box;
  const bool nan = is_nan(t1x) || is_nan(t2x) || is_nan(t1y) || is_nan(t2y) ||
                   is_nan(t1z) || is_nan(t2z);
  return !nan && box;
}

// A leaf code's triangles against the ray (leaf_test's closest update).
__device__ __forceinline__ void threaded_leaf(const float4* __restrict__ tris, int code,
                                              const Ray& r, TriHit& best) {
  const int packed = -1 - code;
  leaf_test<false>(tris, packed >> 4, packed & 15, r, best);
}

// The walk of one ray (LEAN: the lean box test) into `best`; `warp`: the
// lanes of the warp that take part, every one of them calling it; `past`:
// with COUNT, the visits made with a leaf pending. Any hit tests each leaf
// in the node loop as its box passes and postpones none.
template <bool ANY_HIT, bool LEAN, bool COUNT>
__device__ __forceinline__ void threaded_walk_as(const float4* __restrict__ nodes, int limit,
                                                 const float4* __restrict__ tris, const Ray& r,
                                                 unsigned warp, TriHit& best, int& past) {
  int cur = 0;   // the root
  int steps = 0;
  if constexpr (ANY_HIT) {
    for (; cur >= 0 && steps < limit; ++steps) {
      const float4 a = __ldg(nodes + 2 * cur);
      const float4 b = __ldg(nodes + 2 * cur + 1);
      const bool box = threaded_box<LEAN>(a, b, r, best.t);
      const int enter = __float_as_int(b.z);
      if (box && enter < 0) {
        threaded_leaf(tris, enter, r, best);
        if (best.slot >= 0) return;
      }
      cur = box && enter >= 0 ? enter : __float_as_int(b.w);
    }
    return;
  }
  bool live = true;   // the walk goes on: a leaf pending, or nodes to visit
  while (__any_sync(warp, live)) {
    int leaf = 0;   // the pending leaf's code (< 0), or none
    bool walking = live && cur >= 0 && steps < limit;
    // on while some lane walks and not every walking lane holds a leaf
    while (__any_sync(warp, walking) && !__all_sync(warp, !walking || leaf != 0)) {
      if (!walking) continue;
      ++steps;
      if constexpr (COUNT) past += leaf != 0;
      const float4 a = __ldg(nodes + 2 * cur);
      const float4 b = __ldg(nodes + 2 * cur + 1);
      const bool box = threaded_box<LEAN>(a, b, r, best.t);
      const int enter = __float_as_int(b.z);
      if (box && enter < 0) {
        if (leaf != 0) {   // a second hit leaf: visited again after the first's test
          walking = false;
          continue;
        }
        leaf = enter;
        cur = __float_as_int(b.w);
      } else {
        cur = box ? enter : __float_as_int(b.w);
      }
      walking = cur >= 0 && steps < limit;
    }
    if (leaf != 0) threaded_leaf(tris, leaf, r, best);
    else live = false;
  }
}

// The walk of one ray below max_t -> its closest hit (any hit: the closest
// slot of the first blocking leaf), slot -1 on a miss. `lean`: the tables'
// box planes hold no NaN (tame rays may take the lean box test); `warp`, as
// threaded_walk_as.
template <bool ANY_HIT, bool COUNT>
__device__ __forceinline__ TriHit threaded_walk(const float4* __restrict__ nodes, int n_nodes,
                                                bool lean, const float4* __restrict__ tris,
                                                const Ray& r, float max_t, unsigned warp,
                                                int& past) {
  TriHit best{max_t, -1};
  const int limit = 2 * n_nodes + 4;
  if (lean && is_tame(r))
    threaded_walk_as<ANY_HIT, true, COUNT>(nodes, limit, tris, r, warp, best, past);
  else
    threaded_walk_as<ANY_HIT, false, COUNT>(nodes, limit, tris, r, warp, best, past);
  return best;
}

}  // namespace rt
