// K1 unordered: the stackless walk over the binary BVH's threaded hit and
// miss links, closest hit or any hit of N rays, one ray per thread.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/traverse.py _kernel
// (:690), which pallas_packet_traverse(..., ordered=False) launches (:843-854)
// over the node rows of pack_node_rows(ordered=False). There one cursor walks
// for a whole 1024-8192-ray packet and follows hit_link when ANY lane of the
// packet hits the box, so every lane pays for the union of the packet's
// paths. Here every thread walks its own ray with its own cursor: no stack,
// no shared memory, a handful of registers. Its plain version is
// ops/bvh_traverse.py::bvh_traverse_threaded; ops/cuda/traverse.py
// ::traverse_threaded is the wrapper, pack_threaded_tables lays out:
//   nodes: one binary node per 48 bytes (three float4, 16-byte aligned):
//          (min.x, min.y, min.z, max.x), (max.y, max.z, hit_link, miss_link),
//          (first slot, leaf count, 0, 0), the integers as int32 bits;
//          hit_link is the left child or, for a leaf, the next subtree in
//          left-first order; -1 ends the walk;
//   tris:  K1's triangle rows (traverse.cuh leaf_test): three float4 per
//          leaf-ordered slot, (v0, material), (e1, 0), (e2, 0).
//
// Semantics are the plain walk's, so the kernel is bit-exact to it on t,
// slot and hit (built -fmad=false, IEEE division): the box test is
// tmax >= 0 && tmin <= tmax && tmin <= best_t with NaN slabs rejecting (as
// torch.minimum / amax propagate NaN), a hit box leads to hit_link and a
// leaf's slots go through leaf_test's strict-< closest update; both walk the
// same left-first order and so keep the same winner on equal t. In any-hit
// mode a ray finishes the leaf it found a blocker in (the closest slot of
// that leaf, as the plain walk) and stops. The JAX kernel's box test is the
// clamped strict one (ce = max(tmin, 0), ce <= tmax && ce < best_t,
// traverse.py:737-738), which visits a subset of these nodes: its winners
// agree except where a triangle's t and a box's entry distance tie to the
// ulp, lanes the comparisons count.
//
// What bounds it on an H100: the work of the walk, not bytes. Left-first
// order visits far subtrees before near ones and culls only at best_t, so a
// camera ray of the 100k-triangle courtyard visits several times the nodes
// of K1's near-first walk (chip_smoke.py phase 24 counts them with the plain
// walk); every visit is one dependent 48-byte load (the ~0.5 MB node table
// stays in L2) and 25 operations of slab test, and the lanes of a warp
// diverge once their paths part. Nothing on a main path launches it, as in
// the JAX package; it is kept simple and right.
#include <cuda_runtime.h>

#include "traverse.cuh"

namespace rt {

template <bool ANY_HIT>
__global__ void __launch_bounds__(kRenderBlock)
traverse_threaded_kernel(const float4* __restrict__ nodes, int n_nodes,
                         const float4* __restrict__ tris, const float* __restrict__ orig,
                         const float* __restrict__ dirn, const float* __restrict__ max_t, int n,
                         float* __restrict__ t_out, int* __restrict__ slot_out,
                         float* __restrict__ normal_out, int* __restrict__ mat_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                         dirn[3 * i], dirn[3 * i + 1], dirn[3 * i + 2]);
  TriHit best{max_t[i], -1};
  int cur = 0;   // the root
  // a threaded walk visits each node at most once; the bound is the plain
  // walk's, n_nodes + 4 steps
  for (int step = 0; cur >= 0 && step < n_nodes + 4; ++step) {
    const float4 a = __ldg(nodes + 3 * cur);
    const float4 b = __ldg(nodes + 3 * cur + 1);
    const float4 c = __ldg(nodes + 3 * cur + 2);
    const float t1x = (a.x - r.ox) * r.ix;
    const float t1y = (a.y - r.oy) * r.iy;
    const float t1z = (a.z - r.oz) * r.iz;
    const float t2x = (a.w - r.ox) * r.ix;
    const float t2y = (b.x - r.oy) * r.iy;
    const float t2z = (b.y - r.oz) * r.iz;
    const bool nan = is_nan(t1x) || is_nan(t2x) || is_nan(t1y) || is_nan(t2y) ||
                     is_nan(t1z) || is_nan(t2z);
    const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    const bool box = !nan && tmax >= 0.0f && tmin <= tmax && tmin <= best.t;
    const int count = __float_as_int(c.y);
    if (box && count > 0) {
      leaf_test<false>(tris, __float_as_int(c.x), count, r, best);
      if (ANY_HIT && best.slot >= 0) break;
    }
    cur = __float_as_int(box ? b.z : b.w);
  }
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int mat = -1;
  if (best.slot >= 0) tri_attributes(tris, best.slot, nx, ny, nz, mat);
  t_out[i] = best.slot >= 0 ? best.t : kMissT;
  slot_out[i] = best.slot;
  normal_out[3 * i] = nx;
  normal_out[3 * i + 1] = ny;
  normal_out[3 * i + 2] = nz;
  mat_out[i] = mat;
}

}  // namespace rt

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_traverse_threaded(const void* nodes, int n_nodes, const void* tris,
                                    const void* orig, const void* dirn, const void* max_t,
                                    int n, int any_hit, void* t_out, void* slot_out,
                                    void* normal_out, void* mat_out, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(rt::kRenderBlock);
  const dim3 grid((n + rt::kRenderBlock - 1) / rt::kRenderBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nd = static_cast<const float4*>(nodes);
  const auto tr = static_cast<const float4*>(tris);
  const auto o = static_cast<const float*>(orig);
  const auto d = static_cast<const float*>(dirn);
  const auto mt = static_cast<const float*>(max_t);
  const auto t = static_cast<float*>(t_out);
  const auto slot = static_cast<int*>(slot_out);
  const auto nrm = static_cast<float*>(normal_out);
  const auto mat = static_cast<int*>(mat_out);
  if (any_hit)
    rt::traverse_threaded_kernel<true>
        <<<grid, block, 0, s>>>(nd, n_nodes, tr, o, d, mt, n, t, slot, nrm, mat);
  else
    rt::traverse_threaded_kernel<false>
        <<<grid, block, 0, s>>>(nd, n_nodes, tr, o, d, mt, n, t, slot, nrm, mat);
  return static_cast<int>(cudaGetLastError());
}
