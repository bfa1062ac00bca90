// K1 standalone launch: closest-hit or any-hit of N rays, one ray per thread.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/traverse.py
// pallas_packet_traverse (pallas_call at :851), which ops/trace.py calls on the
// chip. The traversal itself, what bounds it on this card and what its design
// does about that are in traverse.cuh. This launch adds only the ray loads
// ([N,3] origins and directions, [N] max_t) and the result stores (t, slot,
// unit normal, material), 44 bytes per ray in and out.
#include <cuda_runtime.h>

#include "traverse.cuh"

namespace {

template <int STACK, bool ANY_HIT>
__global__ void __launch_bounds__(rt::kRenderBlock, rt::kRenderMinBlocks)
traverse_kernel(const rt::Node4* __restrict__ nodes, const float4* __restrict__ tris,
                const float* __restrict__ orig, const float* __restrict__ dirn,
                const float* __restrict__ max_t, int n, float* __restrict__ t_out,
                int* __restrict__ slot_out, float* __restrict__ normal_out,
                int* __restrict__ mat_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rt::Ray r = rt::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                                 dirn[3 * i], dirn[3 * i + 1], dirn[3 * i + 2]);
  const rt::TriHit best = rt::traverse_bvh4<STACK, ANY_HIT>(nodes, tris, r, max_t[i]);
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int mat = -1;
  if (!ANY_HIT && best.slot >= 0) rt::tri_attributes(tris, best.slot, nx, ny, nz, mat);
  t_out[i] = best.slot >= 0 ? best.t : rt::kMissT;
  slot_out[i] = best.slot;
  normal_out[3 * i] = nx;
  normal_out[3 * i + 1] = ny;
  normal_out[3 * i + 2] = nz;
  mat_out[i] = mat;
}

// The same walk with its work counted: (nodes, triangles, node-body and
// triangle-body iterations led for the warp) per ray, rt::Work. Used to compute
// the roofline bound of the traversing kernels and the SIMT efficiency of the
// walk, never by the renderer.
template <int STACK, bool ANY_HIT>
__global__ void __launch_bounds__(rt::kRenderBlock, rt::kRenderMinBlocks)
traverse_work_kernel(const rt::Node4* __restrict__ nodes, const float4* __restrict__ tris,
                     const float* __restrict__ orig, const float* __restrict__ dirn,
                     const float* __restrict__ max_t, int n, int4* __restrict__ work_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rt::Ray r = rt::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                                 dirn[3 * i], dirn[3 * i + 1], dirn[3 * i + 2]);
  rt::Work w{0, 0, 0, 0};
  rt::traverse_bvh4<STACK, ANY_HIT, true>(nodes, tris, r, max_t[i], &w);
  work_out[i] = make_int4(w.nodes, w.tris, w.warp_nodes, w.warp_tris);
}

template <int STACK>
void launch(bool any_hit, dim3 grid, dim3 block, cudaStream_t s, const rt::Node4* nodes,
            const float4* tris, const float* o, const float* d, const float* m, int n,
            float* t, int* slot, float* nrm, int* mat) {
  if (any_hit)
    traverse_kernel<STACK, true>
        <<<grid, block, 0, s>>>(nodes, tris, o, d, m, n, t, slot, nrm, mat);
  else
    traverse_kernel<STACK, false>
        <<<grid, block, 0, s>>>(nodes, tris, o, d, m, n, t, slot, nrm, mat);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a stack capacity that was not compiled.
extern "C" int rt_traverse(const void* nodes, const void* tris, int stack, const void* orig,
                           const void* dirn, const void* max_t, int n, int any_hit,
                           void* t_out, void* slot_out, void* normal_out, void* mat_out,
                           void* stream) {
  if (n <= 0) return 0;
  const dim3 block(rt::kRenderBlock);
  const dim3 grid((n + rt::kRenderBlock - 1) / rt::kRenderBlock);
  auto s = static_cast<cudaStream_t>(stream);
  auto nd = static_cast<const rt::Node4*>(nodes);
  auto tr = static_cast<const float4*>(tris);
  auto o = static_cast<const float*>(orig);
  auto d = static_cast<const float*>(dirn);
  auto m = static_cast<const float*>(max_t);
  auto t = static_cast<float*>(t_out);
  auto sl = static_cast<int*>(slot_out);
  auto nr = static_cast<float*>(normal_out);
  auto mt = static_cast<int*>(mat_out);
  switch (stack) {
    case 16: launch<16>(any_hit, grid, block, s, nd, tr, o, d, m, n, t, sl, nr, mt); break;
    case 32: launch<32>(any_hit, grid, block, s, nd, tr, o, d, m, n, t, sl, nr, mt); break;
    case 64: launch<64>(any_hit, grid, block, s, nd, tr, o, d, m, n, t, sl, nr, mt); break;
    case 128: launch<128>(any_hit, grid, block, s, nd, tr, o, d, m, n, t, sl, nr, mt); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a stack capacity that was not compiled.
extern "C" int rt_traverse_work(const void* nodes, const void* tris, int stack,
                                const void* orig, const void* dirn, const void* max_t, int n,
                                int any_hit, void* work_out, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(rt::kRenderBlock);
  const dim3 grid((n + rt::kRenderBlock - 1) / rt::kRenderBlock);
  auto s = static_cast<cudaStream_t>(stream);
  auto nd = static_cast<const rt::Node4*>(nodes);
  auto tr = static_cast<const float4*>(tris);
  auto o = static_cast<const float*>(orig);
  auto d = static_cast<const float*>(dirn);
  auto m = static_cast<const float*>(max_t);
  auto w = static_cast<int4*>(work_out);
#define RT_LAUNCH(S)                                                             \
  if (any_hit)                                                                   \
    traverse_work_kernel<S, true><<<grid, block, 0, s>>>(nd, tr, o, d, m, n, w); \
  else                                                                           \
    traverse_work_kernel<S, false><<<grid, block, 0, s>>>(nd, tr, o, d, m, n, w);
  switch (stack) {
    case 16: RT_LAUNCH(16); break;
    case 32: RT_LAUNCH(32); break;
    case 64: RT_LAUNCH(64); break;
    case 128: RT_LAUNCH(128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
