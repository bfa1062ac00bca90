// K1 unordered: the stackless walk over the binary BVH's threaded hit and
// miss links, closest hit or any hit of N rays, one ray per thread.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/traverse.py _kernel
// (:690), which pallas_packet_traverse(..., ordered=False) launches (:843-854)
// over the node rows of pack_node_rows(ordered=False). There one cursor walks
// for a whole 1024-8192-ray packet and follows hit_link when ANY lane of the
// packet hits the box, so every lane pays for the union of the packet's
// paths. Here every thread walks its own ray with its own cursor: no stack,
// no shared memory. Its plain version is
// ops/bvh_traverse.py::bvh_traverse_threaded; ops/cuda/traverse.py
// ::traverse_threaded is the wrapper, pack_threaded_tables lays out the
// tables. The walk itself is threaded_walk.cuh, laid out for the card: a
// 32-byte node record read as one sector, the lean box test for tame rays,
// and, in closest hit, the leaf tests taken out of the node loop and
// postponed while other lanes of the warp still look for a leaf; the same
// semantics, so the kernel is bit-exact to the plain walk on t, slot and
// hit.
//
// The JAX kernel's box test is the clamped strict one (ce = max(tmin, 0),
// ce <= tmax && ce < best_t, traverse.py:737-738), which visits a subset of
// these nodes: its winners agree except where a triangle's t and a box's
// entry distance tie to the ulp, lanes the comparisons count.
//
// What bounds it on an H100: the work of the walk, not bytes (the ~1.2 MB
// node table stays in L2): ~105 node visits and ~32 triangle tests a camera
// ray of the 100k-triangle courtyard, each visit a dependent load (PERF.md).
// Nothing on a main path launches it, as in the JAX package.
#include <cuda_runtime.h>

#include <cstdint>

#include "threaded_walk.cuh"

namespace rt {

template <bool ANY_HIT, bool COUNT>
__global__ void __launch_bounds__(kThreadedBlock, kThreadedMinBlocks)
traverse_threaded_kernel(const float4* __restrict__ nodes, int n_nodes, int lean,
                         const float4* __restrict__ tris, const float* __restrict__ orig,
                         const float* __restrict__ dirn, const float* __restrict__ max_t, int n,
                         float* __restrict__ t_out, int* __restrict__ slot_out,
                         float* __restrict__ normal_out, int* __restrict__ mat_out,
                         int* __restrict__ past_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // the lanes that walk: the walk's votes name them (the block is whole warps)
  const unsigned warp = __ballot_sync(0xffffffffu, i < n);
  if (i >= n) return;
  const Ray r = make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                         dirn[3 * i], dirn[3 * i + 1], dirn[3 * i + 2]);
  int past = 0;
  const TriHit best =
      threaded_walk<ANY_HIT, COUNT>(nodes, n_nodes, lean != 0, tris, r, max_t[i], warp, past);
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int mat = -1;
  if (best.slot >= 0) tri_attributes(tris, best.slot, nx, ny, nz, mat);
  t_out[i] = best.slot >= 0 ? best.t : kMissT;
  slot_out[i] = best.slot;
  normal_out[3 * i] = nx;
  normal_out[3 * i + 1] = ny;
  normal_out[3 * i + 2] = nz;
  mat_out[i] = mat;
  if constexpr (COUNT) past_out[i] = past;
}

}  // namespace rt

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a node table off a 32-byte boundary. `lean`: the
// tables' box planes hold no NaN. With `past_out` (int32 [n]) the COUNT
// instance runs and also writes each ray's visits made with a leaf pending.
extern "C" int rt_traverse_threaded(const void* nodes, int n_nodes, int lean, const void* tris,
                                    const void* orig, const void* dirn, const void* max_t,
                                    int n, int any_hit, void* t_out, void* slot_out,
                                    void* normal_out, void* mat_out, void* past_out,
                                    void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(nodes) % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(rt::kThreadedBlock);
  const dim3 grid((n + rt::kThreadedBlock - 1) / rt::kThreadedBlock);
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
  const auto past = static_cast<int*>(past_out);
  if (any_hit && past)
    rt::traverse_threaded_kernel<true, true>
        <<<grid, block, 0, s>>>(nd, n_nodes, lean, tr, o, d, mt, n, t, slot, nrm, mat, past);
  else if (any_hit)
    rt::traverse_threaded_kernel<true, false>
        <<<grid, block, 0, s>>>(nd, n_nodes, lean, tr, o, d, mt, n, t, slot, nrm, mat, past);
  else if (past)
    rt::traverse_threaded_kernel<false, true>
        <<<grid, block, 0, s>>>(nd, n_nodes, lean, tr, o, d, mt, n, t, slot, nrm, mat, past);
  else
    rt::traverse_threaded_kernel<false, false>
        <<<grid, block, 0, s>>>(nd, n_nodes, lean, tr, o, d, mt, n, t, slot, nrm, mat, past);
  return static_cast<int>(cudaGetLastError());
}
