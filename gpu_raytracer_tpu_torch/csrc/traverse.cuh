// K1: BVH4 closest-hit / any-hit traversal, one ray per thread (device code).
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/traverse.py
// (traverse_best -> _ordered_traverse4 / _leaf_test / _normalize_best), which
// walks one shared cursor per 1024-8192-ray packet over 128-lane VMEM rows.
// Here every thread walks its own ray with its own stack, over tables laid out
// for this card by ops/cuda/traverse.py::pack_trace_tables:
//   nodes: one 144-byte record per BVH4 node (9 x 16-byte loads),
//   tris:  three float4 per leaf-ordered triangle slot (v0|mat, e1, e2).
//
// What bounds it on an H100: not arithmetic and not DRAM bandwidth (the
// 100k-triangle courtyard's tables are ~5 MB and stay in the 50 MB L2) but
// the latency of dependent node and triangle loads, and warp divergence when
// the 32 rays of a warp take different paths. What the design does about it:
// 16-byte vector loads of whole records through the read-only path; near-first
// order by each ray's own entry distance, so best_t tightens early and far
// subtrees are culled (again at pop time); callers hand in rays in tile-major
// order, so a warp's rays are neighbours that walk nearly the same nodes.
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

namespace rt {

constexpr float kMinT = 1e-5f;
constexpr float kMissT = 3.402823466e38f;   // f32::MAX

struct __align__(16) Node4 {
  float4 lo_x, lo_y, lo_z, hi_x, hi_y, hi_z;
  int4 child;   // wide node id | leaf first slot | -1
  int4 count;   // leaf triangle count, 0 for internal or empty
  int axis;     // axis the children are sorted on (by centroid)
  int pad0, pad1, pad2;
};
static_assert(sizeof(Node4) == 144, "Node4 must match the 36-word host record");

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  return Ray{ox, oy, oz, dx, dy, dz, 1.0f / dx, 1.0f / dy, 1.0f / dz};
}

struct TriHit {
  float t;
  int slot;   // -1 on a miss
};

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ int lane(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// Stack entry: an internal node id (>= 0) or a leaf, -1 - (first_slot << 4 | count).
struct Entry {
  int code;
  float ce;   // clamped entry distance at push time
};

__device__ __forceinline__ int leaf_code(int first, int count) {
  return -1 - ((first << 4) | count);
}

// The work of one walk, counted only by the COUNT instances (the roofline
// bound's operation count): node records popped and slab-tested, triangles
// intersected.
struct Work {
  int nodes, tris;
};

// One leaf against the ray: closest update with strict <, or the first
// blocker in any-hit mode (returns true when the ray is done).
template <bool ANY_HIT, bool COUNT = false>
__device__ __forceinline__ bool leaf_test(const float4* __restrict__ tris, int first,
                                          int count, const Ray& r, TriHit& best,
                                          Work* work = nullptr) {
  for (int j = 0; j < count; ++j) {
    if (COUNT) ++work->tris;
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

// Closest hit (or any hit) of triangles strictly below max_t.
template <int STACK, bool ANY_HIT, bool COUNT = false>
__device__ TriHit traverse_bvh4(const Node4* __restrict__ nodes,
                                const float4* __restrict__ tris, const Ray& r,
                                float max_t, Work* work = nullptr) {
  TriHit best{max_t, -1};
  Entry stack[STACK];
  int sp = 0;
  stack[sp++] = Entry{0, 0.0f};   // the root node
  while (sp > 0) {
    const Entry e = stack[--sp];
    if (e.ce >= best.t) continue;   // culled by a hit found since the push
    if (e.code < 0) {
      const int packed = -1 - e.code;
      if (leaf_test<ANY_HIT, COUNT>(tris, packed >> 4, packed & 15, r, best, work)) return best;
      continue;
    }
    if (COUNT) ++work->nodes;
    const float4* rec = reinterpret_cast<const float4*>(nodes + e.code);
    const float4 lo_x = __ldg(rec + 0), lo_y = __ldg(rec + 1), lo_z = __ldg(rec + 2);
    const float4 hi_x = __ldg(rec + 3), hi_y = __ldg(rec + 4), hi_z = __ldg(rec + 5);
    const int4 child = __ldg(reinterpret_cast<const int4*>(rec + 6));
    const int4 count = __ldg(reinterpret_cast<const int4*>(rec + 7));
    const int axis = __ldg(reinterpret_cast<const int*>(rec + 8));
    const float d_axis = axis == 0 ? r.dx : axis == 1 ? r.dy : r.dz;
    const bool forward = d_axis >= 0.0f;

    // slab-test the four children; keep the hits sorted by entry distance,
    // equal distances in the children's stored order along the ray
    int hit_code[4];
    float hit_ce[4];
    int nh = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = forward ? k : 3 - k;
      const int ch = lane(child, c);
      const float t1x = (lane(lo_x, c) - r.ox) * r.ix;
      const float t2x = (lane(hi_x, c) - r.ox) * r.ix;
      const float t1y = (lane(lo_y, c) - r.oy) * r.iy;
      const float t2y = (lane(hi_y, c) - r.oy) * r.iy;
      const float t1z = (lane(lo_z, c) - r.oz) * r.iz;
      const float t2z = (lane(hi_z, c) - r.oz) * r.iz;
      const bool nan = is_nan(t1x) || is_nan(t2x) || is_nan(t1y) || is_nan(t2y) ||
                       is_nan(t1z) || is_nan(t2z);
      const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
      const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
      const float ce = fmaxf(tmin, 0.0f);
      if (ch >= 0 && !nan && ce <= tmax && ce < best.t) {
        const int n = lane(count, c);
        const int code = n > 0 ? leaf_code(ch, n) : ch;
        int p = nh++;
        while (p > 0 && hit_ce[p - 1] > ce) {
          hit_code[p] = hit_code[p - 1];
          hit_ce[p] = hit_ce[p - 1];
          --p;
        }
        hit_code[p] = code;
        hit_ce[p] = ce;
      }
    }
    // far first, so the nearest child is popped next
    for (int p = nh - 1; p >= 0; --p) stack[sp++] = Entry{hit_code[p], hit_ce[p]};
  }
  return best;
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
