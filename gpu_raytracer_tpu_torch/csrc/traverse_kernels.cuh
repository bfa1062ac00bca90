// K1's standalone kernels, closest-hit or any-hit of N rays, one ray per
// thread, and their launch for a node table of width W: the width-4
// instances compile in traverse.cu, the width-8 ones in traverse_w8.cu.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas/traverse.py
// pallas_packet_traverse (pallas_call at :851), which ops/trace.py calls on the
// chip, at both of its widths. The traversal itself, what bounds it on this
// card and what its design does about that are in traverse.cuh. This launch
// adds only the ray loads ([N,3] origins and directions, [N] max_t) and the
// result stores (t, slot, unit normal, material), 44 bytes per ray in and out.
// The registers are capped for kRenderMinBlocks blocks an SM, and for the
// width-8 instances kRenderMinBlocksW8 (traverse.cuh; 6 each, 80 registers).
#pragma once

#include <cuda_runtime.h>

#include "traverse.cuh"

namespace rt {

template <int W, int STACK, bool ANY_HIT>
__global__ void __launch_bounds__(kRenderBlock, W == 8 ? kRenderMinBlocksW8 : kRenderMinBlocks)
traverse_kernel(const Node<W>* __restrict__ nodes, const float4* __restrict__ tris,
                const float* __restrict__ orig, const float* __restrict__ dirn,
                const float* __restrict__ max_t, int n, float* __restrict__ t_out,
                int* __restrict__ slot_out, float* __restrict__ normal_out,
                int* __restrict__ mat_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                         dirn[3 * i], dirn[3 * i + 1], dirn[3 * i + 2]);
  const TriHit best = traverse_bvh<W, STACK, ANY_HIT>(nodes, tris, r, max_t[i]);
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int mat = -1;
  if (!ANY_HIT && best.slot >= 0) tri_attributes(tris, best.slot, nx, ny, nz, mat);
  t_out[i] = best.slot >= 0 ? best.t : kMissT;
  slot_out[i] = best.slot;
  normal_out[3 * i] = nx;
  normal_out[3 * i + 1] = ny;
  normal_out[3 * i + 2] = nz;
  mat_out[i] = mat;
}

// The same walk with its work counted: (nodes, triangles, node-body and
// triangle-body iterations led for the warp, non-empty child slots of the
// visited nodes) per ray, rt::Work; a node is one record of width W. Used to compute the roofline bound of the traversing
// kernels and the SIMT efficiency of the walk, never by the renderer. At
// width 8, where `ahead_out` is not null, it also adds up the visits by the
// number of children ahead ([9] counts, Work::ahead).
template <int W, int STACK, bool ANY_HIT>
__global__ void __launch_bounds__(kRenderBlock, W == 8 ? kRenderMinBlocksW8 : kRenderMinBlocks)
traverse_work_kernel(const Node<W>* __restrict__ nodes, const float4* __restrict__ tris,
                     const float* __restrict__ orig, const float* __restrict__ dirn,
                     const float* __restrict__ max_t, int n, int* __restrict__ work_out,
                     unsigned* __restrict__ ahead_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                         dirn[3 * i], dirn[3 * i + 1], dirn[3 * i + 2]);
  Work w{0, 0, 0, 0, 0, ahead_out};
  traverse_bvh<W, STACK, ANY_HIT, true>(nodes, tris, r, max_t[i], &w);
  int* out = work_out + 5 * i;
  out[0] = w.nodes;
  out[1] = w.tris;
  out[2] = w.warp_nodes;
  out[3] = w.warp_tris;
  out[4] = w.slots;
}

// The arguments of one K1 launch (host side).
struct TraverseLaunch {
  const void* nodes;
  const float4* tris;
  const float* orig;
  const float* dirn;
  const float* max_t;
  int n;
  bool any_hit;
  float* t;       // closest-hit launch: t, slot, normal, material out
  int* slot;
  float* normal;
  int* mat;
  int* work;      // work launch: the counts out, 5 per ray
  unsigned* ahead;   // work launch at width 8: visits by children ahead, or null
};

// Launch the width-W instance for `stack` (work: the counting kernel);
// returns cudaGetLastError(), or cudaErrorInvalidValue for a stack capacity
// that was not compiled at this width.
template <int W>
int launch_traverse(const TraverseLaunch& a, int stack, bool work, cudaStream_t s) {
  const dim3 block(kRenderBlock);
  const dim3 grid((a.n + kRenderBlock - 1) / kRenderBlock);
  auto nd = static_cast<const Node<W>*>(a.nodes);
#define RT_LAUNCH_K(S, ANY)                                                                 \
  if (work)                                                                                 \
    traverse_work_kernel<W, S, ANY>                                                         \
        <<<grid, block, 0, s>>>(nd, a.tris, a.orig, a.dirn, a.max_t, a.n, a.work, a.ahead); \
  else                                                                                      \
    traverse_kernel<W, S, ANY><<<grid, block, 0, s>>>(nd, a.tris, a.orig, a.dirn, a.max_t,  \
                                                      a.n, a.t, a.slot, a.normal, a.mat)
#define RT_LAUNCH(S)          \
  if (a.any_hit) {            \
    RT_LAUNCH_K(S, true);     \
  } else {                    \
    RT_LAUNCH_K(S, false);    \
  }
  RT_SWITCH_STACK(W, stack, RT_LAUNCH)
#undef RT_LAUNCH
#undef RT_LAUNCH_K
  return static_cast<int>(cudaGetLastError());
}

// The width-8 instances (traverse_w8.cu).
int launch_traverse_w8(const TraverseLaunch& a, int stack, bool work, cudaStream_t s);

}  // namespace rt
