// K1: wide-BVH closest-hit / any-hit traversal, one ray per thread (device
// code), over nodes of width 4 or 8 (walk_bvh<W>).
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/traverse.py
// (traverse_best -> _ordered_traverse4 / _leaf_test / _normalize_best), both
// of its widths, which walks one shared cursor per 1024-8192-ray packet over
// 128-lane VMEM rows. Here every thread walks its own ray with its own stack,
// over tables laid out for this card by ops/cuda/traverse.py::pack_trace_tables:
//   nodes: one record per wide node, Node<W>, 128-byte aligned. At width 4 a
//          node is one cache line (four 32-byte sectors): six float4 of child
//          boxes, one int4 of child codes (a wide node id >= 0, a leaf already
//          as its stack code -1 - (first slot << 4 | count), or -1 for an
//          empty slot), and 16 bytes whose first word is the sort axis. At
//          width 8 it is two lines: twelve float4 of boxes (lo_x[8] ...
//          hi_z[8], each plane two float4), two int4 of codes, the axis and
//          28 pad bytes;
//   tris:  three float4 per leaf-ordered triangle slot (v0|mat, e1, e2).
//
// What bounds it on an H100: instruction throughput, then the latency of dependent
// node loads; not DRAM bandwidth (the 100k-triangle courtyard's tables are
// ~5 MB and stay in the 50 MB L2) and, for camera rays, not divergence: the
// COUNT instances below read 98% of a warp's lanes at work in the node body
// and 94% in the triangle body on the 1080p frame (62% / 48% on the path
// tracer's depth-1 pool). A ray costs ~12 node visits and ~8 triangle tests
// of a few hundred instructions each, almost none of them fused multiply-adds
// (the arithmetic must round like the plain version: -fmad=false, compares,
// selects, min/max), so K1 runs at about a sixth of the FP32 roofline that
// counts its operations, and close to the rate at which the card dispatches them
// (PERF.md). What the design does about it:
//   * one aligned 128-byte line per node, seven 16-byte loads and one 4-byte
//     load through the read-only path;
//   * a while-while walk (Aila and Laine 2009): an inner loop over internal
//     nodes that a lane leaves only when it holds a leaf, then that leaf's
//     triangles, so the lanes of a warp run the node body together and the
//     triangle body together instead of each iteration running both;
//   * the nearest child is entered at once (no push and pop), the others are
//     ordered by a fixed network of six adjacent compare-exchanges on
//     registers (adjacent exchanges on a strict > keep equal distances in
//     their stored order along the ray), with the two child orders (forward,
//     backward along the sort axis) as register swaps: nothing but the stack
//     is indexed dynamically;
//   * a lean slab test for the rays that cannot produce a NaN (finite
//     origin, finite non-zero direction: practically all): the near and far
//     plane of each axis are picked by the direction's sign when the record
//     is loaded, which is what min and max of the two plane distances
//     compute, so 24 min/max and 24 NaN tests per node fall away with the
//     same bits; the general test stays for the others, chosen once per ray;
//   * a shortcut where exactly one child is ahead, the most frequent case
//     (about one child per visit on the courtyard): it is entered without
//     the ordering network or a push, which is what the network would do;
//   * near-first order by each ray's own entry distance, so best_t tightens
//     early and far subtrees are culled (again at pop time); callers hand in
//     rays so that a warp's rays are a compact block of pixels
//     (engine/renderer.py::tiled_pixel_order) or neighbours in the coherence
//     order (ops/wavefront.py::coherence_order).
// Measured and not kept (PERF.md): the stack's top entries in shared memory
// laid out [entry][thread] (no faster than local memory, whose lines L1
// serves), a per-child branch around the NaN tests (slower: more registers),
// other block sizes and register caps than 128 threads with 6 blocks per SM.
// The COUNT instances measure what is left: node and triangle visits per ray
// and, per warp, the iterations of each body and the lanes active in them
// (SIMT efficiency; the card's profilers are not available everywhere).
//
// Width 8 keeps that design: walk_bvh<W> is one loop, leaf step and culling
// pop for both widths, with the child loads, the one-child shortcut and the
// ordering written per width inside it. A width-8 visit loads two
// lines (twelve float4 of boxes, two int4 of codes, the axis) and tests eight
// boxes; the tame test's near and far plane of an axis are each two float4,
// picked by the direction's sign as at width 4. Its closest hit orders the
// children by insertion: each live child's place in the visit order is the
// number of children before it, by entry distance and, on equal distances,
// by the stored order (forward or backward along the axis, as register
// swaps), 28 compares whose results add into a 4-bit rank per child in one
// register; the nearest is entered, the others are stored straight into
// their stack slots, far first. That is the order the width-4 network gives
// (stable), and nothing but the stack is indexed dynamically. Its any hit
// (NEAR_ANY false) ranks nothing: best.t stays max_t until the walk
// returns, so no visit order culls what another visits, and the mask is the
// same in any order; the nearest child is entered (one argmin), the others
// pushed to pop in the stored order, on a stack of child codes without the
// pop-time cull (an entry's distance is below max_t, so none culls). Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
// chip_ab.py --w8): a 1080p camera ray visits 8.0 width-8 nodes against
// 12.2 width-4 ones, 36% of them with two or more children ahead, and the
// walk is issue-bound: the closest node loop is 480 SASS instructions
// against 217, the any-hit one 318 against the ranked walk's 481 (K1 w8 on
// shadow rays 8-10% faster, K3 w8 with shadows 6%, K6 w8 2-3% a sample).
// Measured and not kept: entering the children far first along the axis or
// in the stored order (50-72% more visits toward a point light: slower), a
// 19-exchange sorting network on (distance, position) for the closest hit
// (its loop 490, 7.5% slower), other width-8 register caps
// (kRenderMinBlocksW8, kBounceMinBlocksW8 below). The fused textured frame
// kernel K2t keeps the near-first shadow walk (NEAR_ANY): with the other
// one its frames read slower without shadows, the same camera walk in code
// that the compiler laid out differently; K2 takes the unranked one
// (primary_pixel.cuh).
//
// The camera-relative walk (REL; the camera rays of K3, render_deferred.cuh,
// of K2t and of K2 at width 8, primary_pixel.cuh): every ray of a batch
// that starts at one origin o
// computes the same plane - o for every child box and the same s = o - v0,
// q = s x e1 and e2 . q for every triangle. camera_relative.cu computes them
// once per frame into tables of their own, with the same operations in the
// same order, and the REL walk reads them in place of `nodes` (the box words
// plane - o) and `tris` (four float4 a slot: (e1, e2 . q), (e2, 0), (s, 0),
// (q, 0)): each value is the per-ray one bit for bit, so the visits, the tests and the winners are the
// same, for 6 subtractions fewer per child slab test and 17 operations fewer
// per triangle test.
//
// Semantics kept from the reference traversal (ops/pallas/traverse.py:537-538
// and :242-245): slab entry clamped at 0, accept ce <= tmax && ce < best_t
// (a NaN slab, from a zero direction component on a box plane, rejects);
// Moller-Trumbore with |a| >= 1e-5, u >= 0, u <= 1, v >= 0, u + v <= 1,
// 1e-5 < t < best_t, strict < so the first triangle found at a given t keeps
// it. Near-first order may pick another winner than the reference's
// left-first order where two triangles share the exact same t; the closest t
// is the same. Build with -fmad=false so every product rounds on its own, as
// in the plain PyTorch version.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// Launch shape of the traversing kernels, from a measured sweep on an H100
// (PERF.md): threads per block and the minimum resident blocks per SM that
// ptxas is asked to fit the registers to, for the frame kernels (K1, K2, K2t,
// K3) and for the bounce (K6).
#ifndef RT_RENDER_BLOCK
#define RT_RENDER_BLOCK 128
#endif
#ifndef RT_RENDER_MIN_BLOCKS
#define RT_RENDER_MIN_BLOCKS 6
#endif
#ifndef RT_BOUNCE_BLOCK
#define RT_BOUNCE_BLOCK 128
#endif
#ifndef RT_BOUNCE_MIN_BLOCKS
#define RT_BOUNCE_MIN_BLOCKS 4
#endif

namespace rt {

constexpr float kMinT = 1e-5f;
constexpr float kMissT = 3.402823466e38f;   // f32::MAX
constexpr int kRenderBlock = RT_RENDER_BLOCK;
constexpr int kRenderMinBlocks = RT_RENDER_MIN_BLOCKS;
constexpr int kBounceBlock = RT_BOUNCE_BLOCK;
constexpr int kBounceMinBlocks = RT_BOUNCE_MIN_BLOCKS;
// The width-8 instances' own minimum resident blocks per SM (their register
// caps; width 4 keeps the two above): the frame kernels' (K1, K2, K2t, K3)
// and the bounce's (K6); `chip_ab.py --w8 --variants kName=VALUE` sweeps
// them (PERF.md).
constexpr int kRenderMinBlocksW8 = 6;
constexpr int kBounceMinBlocksW8 = 4;

// One wide node of W = 4 or 8 children: the child boxes as six planes of W
// floats, lo_x[W], lo_y[W], lo_z[W], hi_x[W], hi_y[W], hi_z[W] (W / 4 float4
// each), then the child codes, the sort axis and W - 1 pad words.
template <int W>
struct __align__(128) Node {
  static_assert(W == 4 || W == 8, "the wide BVH has 4 or 8 children per node");
  float4 box[6 * (W / 4)];
  int4 code[W / 4];   // per child: wide node id | leaf code (< -1) | -1 empty
  int axis;           // axis the children are sorted on (by centroid)
  int pad[W - 1];
};
static_assert(sizeof(Node<4>) == 128, "Node<4> must match the 32-word host record");
static_assert(sizeof(Node<8>) == 256, "Node<8> must match the 64-word host record");

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Whether no slab product of this ray can be NaN: a finite origin and finite
// non-zero direction components (so finite non-zero inverses) times box planes
// that are finite give finite or infinite distances, never 0 * inf. Almost
// every ray is tame, and a warp of tame rays skips the six NaN tests per child.
__device__ __forceinline__ bool is_tame(const Ray& r) {
  const float big = 3.402823466e38f;
  return fabsf(r.ox) <= big && fabsf(r.oy) <= big && fabsf(r.oz) <= big &&
         fabsf(r.dx) <= big && fabsf(r.dy) <= big && fabsf(r.dz) <= big &&
         fabsf(r.ix) <= big && fabsf(r.iy) <= big && fabsf(r.iz) <= big;
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  return Ray{ox, oy, oz, dx, dy, dz, 1.0f / dx, 1.0f / dy, 1.0f / dz};
}

struct TriHit {
  float t;
  int slot;   // -1 on a miss
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// The work of one walk, counted only by the COUNT instances: node records
// visited and triangles intersected by this ray, the iterations of the node
// body and of the triangle body that this lane led as the lowest active lane
// of its warp, and the non-empty child slots of the visited records (the
// slab tests the closest hit needs: the roofline bound's operation count; a
// visit also tests its empty slots, which the bound does not charge). Summed
// over a launch, nodes / (32 * warp_nodes) is the SIMT efficiency of the
// node body (the share of a warp's lanes at work in it), and the same for
// tris. `deepest`: the most entries this ray's stack held at once, which
// STACK must not fall below (ops/cuda/traverse.py::stack_capacity bounds it).
struct Work {
  int nodes, tris, warp_nodes, warp_tris, slots;
  // width 8, where not null: ahead[k] += 1 for each visit with k children
  // ahead (0 .. 8), summed over every ray of the launch
  unsigned* ahead = nullptr;
  int deepest = 0;
};

// After a push: the stack's height `sp` into Work::deepest.
__device__ __forceinline__ void count_depth(Work* work, int sp) {
  work->deepest = sp > work->deepest ? sp : work->deepest;
}

// One more iteration of a body: `mine` counts the lane, `led` the warp.
__device__ __forceinline__ void count_iteration(int& mine, int& led) {
  const unsigned active = __activemask();
  ++mine;
  if ((threadIdx.x & 31) == __ffs(active) - 1) ++led;
}

// Stack entry: an internal node id (>= 0) or a leaf code (< -1), and the
// child's clamped entry distance at push time.
struct Entry {
  int code;
  float ce;
};

constexpr float kInf = __builtin_huge_valf();

// Clamped slab entry distance of one child box, or +inf where the ray misses
// it, the slot is empty, or the box cannot hold anything closer than best_t.
// The general form: any ray, NaN slabs rejected. REL: the planes are given
// relative to the ray's origin already (plane - o).
template <bool REL = false>
__device__ __forceinline__ float child_entry(float lo_x, float lo_y, float lo_z, float hi_x,
                                             float hi_y, float hi_z, int code, const Ray& r,
                                             float best_t) {
  float t1x, t2x, t1y, t2y, t1z, t2z;
  if constexpr (REL) {
    t1x = lo_x * r.ix;
    t2x = hi_x * r.ix;
    t1y = lo_y * r.iy;
    t2y = hi_y * r.iy;
    t1z = lo_z * r.iz;
    t2z = hi_z * r.iz;
  } else {
    t1x = (lo_x - r.ox) * r.ix;
    t2x = (hi_x - r.ox) * r.ix;
    t1y = (lo_y - r.oy) * r.iy;
    t2y = (hi_y - r.oy) * r.iy;
    t1z = (lo_z - r.oz) * r.iz;
    t2z = (hi_z - r.oz) * r.iz;
  }
  const bool nan = is_nan(t1x) || is_nan(t2x) || is_nan(t1y) || is_nan(t2y) ||
                   is_nan(t1z) || is_nan(t2z);
  const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  const float ce = fmaxf(tmin, 0.0f);
  const bool ok = code != -1 && !nan && ce <= tmax && ce < best_t;
  return ok ? ce : kInf;
}

// The same for a tame ray (is_tame), given each axis' near and far plane by
// the sign of the direction: with a finite non-zero inverse the nearer plane's
// distance IS min(t1, t2) and the farther one's max(t1, t2) (rounding is
// monotone and every box has lo <= hi), and no product is NaN, so the six
// min/max and the six NaN tests per child fall away with the same result.
// REL as in child_entry.
template <bool REL = false>
__device__ __forceinline__ float child_entry_tame(float near_x, float near_y, float near_z,
                                                  float far_x, float far_y, float far_z,
                                                  int code, const Ray& r, float best_t) {
  float tmin, tmax;
  if constexpr (REL) {
    tmin = fmaxf(fmaxf(near_x * r.ix, near_y * r.iy), near_z * r.iz);
    tmax = fminf(fminf(far_x * r.ix, far_y * r.iy), far_z * r.iz);
  } else {
    tmin = fmaxf(fmaxf((near_x - r.ox) * r.ix, (near_y - r.oy) * r.iy),
                 (near_z - r.oz) * r.iz);
    tmax = fminf(fminf((far_x - r.ox) * r.ix, (far_y - r.oy) * r.iy),
                 (far_z - r.oz) * r.iz);
  }
  const float ce = fmaxf(tmin, 0.0f);
  const bool ok = code != -1 && ce <= tmax && ce < best_t;
  return ok ? ce : kInf;
}

// Exchange two neighbours of the child order when the first is strictly
// farther: equal distances (and misses, both +inf) keep their order.
__device__ __forceinline__ void order_pair(float& ce_a, int& code_a, float& ce_b, int& code_b) {
  const bool swap = ce_a > ce_b;
  const float ce = swap ? ce_b : ce_a;
  const int code = swap ? code_b : code_a;
  ce_b = swap ? ce_a : ce_b;
  code_b = swap ? code_a : code_b;
  ce_a = ce;
  code_a = code;
}

// One leaf against the ray: closest update with strict <, or the first
// blocker in any-hit mode (returns true when the ray is done).
template <bool ANY_HIT, bool COUNT = false>
__device__ __forceinline__ bool leaf_test(const float4* __restrict__ tris, int first,
                                          int count, const Ray& r, TriHit& best,
                                          Work* work = nullptr) {
  for (int j = 0; j < count; ++j) {
    if (COUNT) count_iteration(work->tris, work->warp_tris);
    const int slot = first + j;
    const float4 a0 = __ldg(tris + 3 * slot + 0);
    const float4 a1 = __ldg(tris + 3 * slot + 1);
    const float4 a2 = __ldg(tris + 3 * slot + 2);
    const float e1x = a1.x, e1y = a1.y, e1z = a1.z;
    const float e2x = a2.x, e2y = a2.y, e2z = a2.z;
    // h = d x e2, a = e1 . h
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    const float f = 1.0f / a;
    const float sx = r.ox - a0.x, sy = r.oy - a0.y, sz = r.oz - a0.z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    // q = s x e1
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
    const float t = f * (e2x * qx + e2y * qy + e2z * qz);
    const bool ok = fabsf(a) >= kMinT && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                    u + v <= 1.0f && t > kMinT && t < best.t;
    if (ok) {
      best.t = t;
      best.slot = slot;
      if (ANY_HIT) return true;
    }
  }
  return false;
}

// leaf_test over the camera-relative triangle rows `rel` (four float4 a
// slot: (e1, e2 . q), (e2, 0), (s, 0), (q, 0), camera_relative.cu) of a ray
// from the origin they were made for: s, q and e2 . q are read, not computed,
// and the rest is leaf_test's arithmetic in its order, so the same bits.
template <bool ANY_HIT, bool COUNT = false>
__device__ __forceinline__ bool leaf_test_rel(const float4* __restrict__ rel, int first,
                                              int count, const Ray& r, TriHit& best,
                                              Work* work = nullptr) {
  for (int j = 0; j < count; ++j) {
    if (COUNT) count_iteration(work->tris, work->warp_tris);
    const int slot = first + j;
    const float4 e1 = __ldg(rel + 4 * slot + 0);   // e1, e2 . q
    const float4 e2 = __ldg(rel + 4 * slot + 1);
    const float4 s = __ldg(rel + 4 * slot + 2);    // o - v0
    const float4 q = __ldg(rel + 4 * slot + 3);    // s x e1
    // h = d x e2, a = e1 . h
    const float hx = r.dy * e2.z - r.dz * e2.y;
    const float hy = r.dz * e2.x - r.dx * e2.z;
    const float hz = r.dx * e2.y - r.dy * e2.x;
    const float a = e1.x * hx + e1.y * hy + e1.z * hz;
    const float f = 1.0f / a;
    const float u = f * (s.x * hx + s.y * hy + s.z * hz);
    const float v = f * (r.dx * q.x + r.dy * q.y + r.dz * q.z);
    const float t = f * e1.w;
    const bool ok = fabsf(a) >= kMinT && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                    u + v <= 1.0f && t > kMinT && t < best.t;
    if (ok) {
      best.t = t;
      best.slot = slot;
      if (ANY_HIT) return true;
    }
  }
  return false;
}

// The walk of one ray over Node<W> records, TAME for a ray that is_tame (the
// lean slab test): one while-while loop, leaf step and culling pop for both
// widths. The child loads, the one-child shortcut and the ordering of two or
// more children ahead are written per width, in `if constexpr` blocks of
// this one function: moving them (or the pop) into inlined helpers changed
// the width-4 kernels' machine code (PERF.md), which must stay as it
// was measured. REL: `nodes` are the camera-relative node records and
// `tris` the camera-relative triangle rows of the ray's origin
// (camera_relative.cu); everything else is the same walk. NEAR_ANY: a
// width-8 any-hit walk in the closest hit's order (else unranked, above).
template <int W, int STACK, bool ANY_HIT, bool TAME, bool COUNT, bool REL = false,
          bool NEAR_ANY = false>
__device__ __forceinline__ TriHit walk_bvh(const Node<W>* __restrict__ nodes,
                                           const float4* __restrict__ tris, const Ray& r,
                                           float max_t, Work* work) {
  constexpr int P = W / 4;   // float4 per plane of a record
  // the width-8 any-hit walk without the distance order: its stack holds
  // child codes alone (no pop-time cull: nothing culls below max_t)
  constexpr bool CODES = W == 8 && ANY_HIT && !NEAR_ANY;
  TriHit best{max_t, -1};
  std::conditional_t<CODES, int, Entry> stack[STACK];
  int sp = 0;
  int cur = 0;   // the root node
  // float4 index of each axis' near plane in a record (lo planes at 0, P,
  // 2P; hi planes at 3P, 4P, 5P); the far plane is the other one
  const int near_x = r.dx > 0.0f ? 0 : 3 * P, near_y = r.dy > 0.0f ? P : 4 * P;
  const int near_z = r.dz > 0.0f ? 2 * P : 5 * P;
  while (true) {
    // ---- internal nodes, until this lane holds a leaf ----
    while (cur >= 0) {
      if (COUNT) count_iteration(work->nodes, work->warp_nodes);
      const float4* rec = reinterpret_cast<const float4*>(nodes + cur);
      if constexpr (W == 4) {
        const int4 code = __ldg(reinterpret_cast<const int4*>(rec + 6));
        const int axis = __ldg(reinterpret_cast<const int*>(rec + 7));
        if constexpr (COUNT)
          work->slots += (code.x != -1) + (code.y != -1) + (code.z != -1) + (code.w != -1);
        float e0, e1, e2, e3;   // the four children's entry distances, stored order
        if (TAME) {
          const float4 nx = __ldg(rec + near_x), ny = __ldg(rec + near_y);
          const float4 nz = __ldg(rec + near_z), fx = __ldg(rec + (3 - near_x));
          const float4 fy = __ldg(rec + (5 - near_y)), fz = __ldg(rec + (7 - near_z));
          e0 = child_entry_tame<REL>(nx.x, ny.x, nz.x, fx.x, fy.x, fz.x, code.x, r, best.t);
          e1 = child_entry_tame<REL>(nx.y, ny.y, nz.y, fx.y, fy.y, fz.y, code.y, r, best.t);
          e2 = child_entry_tame<REL>(nx.z, ny.z, nz.z, fx.z, fy.z, fz.z, code.z, r, best.t);
          e3 = child_entry_tame<REL>(nx.w, ny.w, nz.w, fx.w, fy.w, fz.w, code.w, r, best.t);
        } else {
          const float4 lo_x = __ldg(rec + 0), lo_y = __ldg(rec + 1), lo_z = __ldg(rec + 2);
          const float4 hi_x = __ldg(rec + 3), hi_y = __ldg(rec + 4), hi_z = __ldg(rec + 5);
          e0 = child_entry<REL>(lo_x.x, lo_y.x, lo_z.x, hi_x.x, hi_y.x, hi_z.x, code.x, r,
                                  best.t);
          e1 = child_entry<REL>(lo_x.y, lo_y.y, lo_z.y, hi_x.y, hi_y.y, hi_z.y, code.y, r,
                                  best.t);
          e2 = child_entry<REL>(lo_x.z, lo_y.z, lo_z.z, hi_x.z, hi_y.z, hi_z.z, code.z, r,
                                  best.t);
          e3 = child_entry<REL>(lo_x.w, lo_y.w, lo_z.w, hi_x.w, hi_y.w, hi_z.w, code.w, r,
                                  best.t);
        }
        // one child ahead (most visits): nothing to order, nothing to push
        if ((e0 < kInf) + (e1 < kInf) + (e2 < kInf) + (e3 < kInf) == 1) {
          cur = e0 < kInf ? code.x : e1 < kInf ? code.y : e2 < kInf ? code.z : code.w;
          continue;
        }
        const float d_axis = axis == 0 ? r.dx : axis == 1 ? r.dy : r.dz;
        const bool forward = d_axis >= 0.0f;
        // the children's order along the ray, then by entry distance, equal
        // distances (and the misses at +inf, last) keeping that order: six
        // adjacent compare-exchanges on registers
        float c0 = forward ? e0 : e3, c1 = forward ? e1 : e2;
        float c2 = forward ? e2 : e1, c3 = forward ? e3 : e0;
        int k0 = forward ? code.x : code.w, k1 = forward ? code.y : code.z;
        int k2 = forward ? code.z : code.y, k3 = forward ? code.w : code.x;
        order_pair(c0, k0, c1, k1);
        order_pair(c2, k2, c3, k3);
        order_pair(c1, k1, c2, k2);
        order_pair(c0, k0, c1, k1);
        order_pair(c2, k2, c3, k3);
        order_pair(c1, k1, c2, k2);

        if (c0 < kInf) {
          // enter the nearest child now; the others wait, far first
          cur = k0;
          if (c3 < kInf) stack[sp++] = Entry{k3, c3};
          if (c2 < kInf) stack[sp++] = Entry{k2, c2};
          if (c1 < kInf) stack[sp++] = Entry{k1, c1};
          if constexpr (COUNT) count_depth(work, sp);
          continue;
        }
      } else {
        int code[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int4 c = __ldg(reinterpret_cast<const int4*>(rec + 6 * P + h));
          code[4 * h] = c.x;
          code[4 * h + 1] = c.y;
          code[4 * h + 2] = c.z;
          code[4 * h + 3] = c.w;
        }
        float e[8];   // the eight children's entry distances, stored order
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // children 4h .. 4h + 3
          float4 ax, ay, az, bx, by, bz;   // near and far planes, or lo and hi
          if (TAME) {
            ax = __ldg(rec + near_x + h);
            ay = __ldg(rec + near_y + h);
            az = __ldg(rec + near_z + h);
            bx = __ldg(rec + (3 * P - near_x) + h);
            by = __ldg(rec + (5 * P - near_y) + h);
            bz = __ldg(rec + (7 * P - near_z) + h);
          } else {
            ax = __ldg(rec + h);
            ay = __ldg(rec + P + h);
            az = __ldg(rec + 2 * P + h);
            bx = __ldg(rec + 3 * P + h);
            by = __ldg(rec + 4 * P + h);
            bz = __ldg(rec + 5 * P + h);
          }
          const float ax_[4] = {ax.x, ax.y, ax.z, ax.w}, ay_[4] = {ay.x, ay.y, ay.z, ay.w};
          const float az_[4] = {az.x, az.y, az.z, az.w}, bx_[4] = {bx.x, bx.y, bx.z, bx.w};
          const float by_[4] = {by.x, by.y, by.z, by.w}, bz_[4] = {bz.x, bz.y, bz.z, bz.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            e[4 * h + c] = TAME ? child_entry_tame<REL>(ax_[c], ay_[c], az_[c], bx_[c],
                                                          by_[c], bz_[c], code[4 * h + c], r,
                                                          best.t)
                                : child_entry<REL>(ax_[c], ay_[c], az_[c], bx_[c], by_[c],
                                                     bz_[c], code[4 * h + c], r, best.t);
        }
        int live = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          live += e[c] < kInf;
          if constexpr (COUNT) work->slots += code[c] != -1;
        }
        if constexpr (COUNT) {
          if (work->ahead != nullptr) atomicAdd(work->ahead + live, 1u);
        }
        // one child ahead (most visits): nothing to order, nothing to push
        if (live == 1) {
          int only = code[7];
#pragma unroll
          for (int c = 6; c >= 0; --c) only = e[c] < kInf ? code[c] : only;
          cur = only;
          continue;
        }
        if constexpr (CODES) {
          if (live > 1) {
            // any hit: best.t stays max_t until the walk returns, so no
            // visit order culls what another visits, and the mask is the
            // same in any order; the nearest is entered now (the first of
            // equal distances), the others pushed to pop in the stored
            // order, without ranking them
            float near_ce = e[0];
            int near_c = 0;
#pragma unroll
            for (int c = 1; c < 8; ++c) {
              if (e[c] < near_ce) {
                near_ce = e[c];
                near_c = c;
              }
            }
#pragma unroll
            for (int c = 7; c >= 0; --c) {
              if (e[c] < kInf && c != near_c) stack[sp++] = code[c];
              if (c == near_c) cur = code[c];
            }
            if constexpr (COUNT) count_depth(work, sp);
            continue;
          }
        } else if (live > 1) {
          const int axis = __ldg(reinterpret_cast<const int*>(rec + 7 * P));
          const float d_axis = axis == 0 ? r.dx : axis == 1 ? r.dy : r.dz;
          const bool forward = d_axis >= 0.0f;
          // the children in their order along the ray (stored order, forward
          // or backward), as register swaps
          float v[8];
          int k[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            v[c] = forward ? e[c] : e[7 - c];
            k[c] = forward ? code[c] : code[7 - c];
          }
          // a stable insertion: child c's rank (at bits 4c) counts the
          // children before it, nearer or at the same distance and earlier
          // in that order
          unsigned rank = 0u;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = i + 1; j < 8; ++j) rank += v[i] <= v[j] ? 1u << (4 * j) : 1u << (4 * i);
          // enter the nearest child now; the others wait, far first: rank q
          // (1 .. live - 1) in slot sp + live - 1 - q, so the next nearest is on top
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int q = static_cast<int>((rank >> (4 * c)) & 15u);
            if (v[c] < kInf) {
              if (q == 0) cur = k[c];
              else stack[sp + live - 1 - q] = Entry{k[c], v[c]};
            }
          }
          sp += live - 1;
          if constexpr (COUNT) count_depth(work, sp);
          continue;
        }
      }
      // nothing ahead in this node: the topmost entry that a hit found since
      // its push does not cull
      if constexpr (CODES) {
        cur = sp > 0 ? stack[--sp] : -1;
      } else {
        cur = -1;
        while (sp > 0) {
          const Entry e = stack[--sp];
          if (!(e.ce >= best.t)) {
            cur = e.code;
            break;
          }
        }
      }
      if (cur == -1) return best;
    }

    // ---- the leaf this lane holds ----
    const int packed = -1 - cur;
    if constexpr (REL) {
      if (leaf_test_rel<ANY_HIT, COUNT>(tris, packed >> 4, packed & 15, r, best, work))
        return best;
    } else {
      if (leaf_test<ANY_HIT, COUNT>(tris, packed >> 4, packed & 15, r, best, work)) return best;
    }
    if constexpr (CODES) {
      cur = sp > 0 ? stack[--sp] : -1;
    } else {
      cur = -1;
      while (sp > 0) {
        const Entry e = stack[--sp];
        if (!(e.ce >= best.t)) {
          cur = e.code;
          break;
        }
      }
    }
    if (cur == -1) return best;
  }
}

// Closest hit (or any hit) of triangles strictly below max_t, through the
// walk of the node records' width W; REL and NEAR_ANY as in walk_bvh (REL:
// `nodes` and `tris` are the camera-relative tables of the ray's origin).
template <int W, int STACK, bool ANY_HIT, bool COUNT = false, bool REL = false,
          bool NEAR_ANY = false>
__device__ TriHit traverse_bvh(const Node<W>* __restrict__ nodes,
                               const float4* __restrict__ tris, const Ray& r,
                               float max_t, Work* work = nullptr) {
  if (0.0f >= max_t) return TriHit{max_t, -1};   // no ray: the root is culled unread
  return is_tame(r) ? walk_bvh<W, STACK, ANY_HIT, true, COUNT, REL, NEAR_ANY>(nodes, tris, r,
                                                                              max_t, work)
                    : walk_bvh<W, STACK, ANY_HIT, false, COUNT, REL, NEAR_ANY>(nodes, tris, r,
                                                                               max_t, work);
}

// Stack capacities compiled for every traversing kernel at width W
// (ops/cuda/traverse.py WIDE_STACK_SIZES): expands LAUNCH(S) once per
// capacity in a switch on `stack`; 16 entries only at width 4.
#define RT_SWITCH_STACK(W, stack, LAUNCH)                    \
  switch (stack) {                                           \
    case 16:                                                 \
      if constexpr (W == 4) {                                \
        LAUNCH(16);                                          \
        break;                                               \
      }                                                      \
      return static_cast<int>(cudaErrorInvalidValue);        \
    case 32: LAUNCH(32); break;                              \
    case 64: LAUNCH(64); break;                              \
    case 128: LAUNCH(128); break;                            \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// Unit geometric normal and material of a winning slot.
__device__ __forceinline__ void tri_attributes(const float4* __restrict__ tris, int slot,
                                               float& nx, float& ny, float& nz, int& mat) {
  const float4 a0 = __ldg(tris + 3 * slot + 0);
  const float4 a1 = __ldg(tris + 3 * slot + 1);
  const float4 a2 = __ldg(tris + 3 * slot + 2);
  const float cx = a1.y * a2.z - a1.z * a2.y;
  const float cy = a1.z * a2.x - a1.x * a2.z;
  const float cz = a1.x * a2.y - a1.y * a2.x;
  const float len = sqrtf(cx * cx + cy * cy + cz * cz);
  nx = cx / len;
  ny = cy / len;
  nz = cz / len;
  mat = __float_as_int(a0.w);
}

}  // namespace rt
