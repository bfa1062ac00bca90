// K1 standalone launch: the entry points and the width-4 instances (the
// kernels are in traverse_kernels.cuh, the width-8 instances in
// traverse_w8.cu, compiled in parallel with this file).
#include <cuda_runtime.h>

#include "traverse_kernels.cuh"

namespace {

// The instance of the node table's width; cudaErrorInvalidValue for another width.
int launch_width(const rt::TraverseLaunch& a, int width, int stack, bool work,
                 cudaStream_t s) {
  if (width == 4) return rt::launch_traverse<4>(a, stack, work, s);
  if (width == 8) return rt::launch_traverse_w8(a, stack, work, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a width or stack capacity that was not compiled.
extern "C" int rt_traverse(const void* nodes, const void* tris, int width, int stack,
                           const void* orig, const void* dirn, const void* max_t, int n,
                           int any_hit, void* t_out, void* slot_out, void* normal_out,
                           void* mat_out, void* stream) {
  if (n <= 0) return 0;
  const rt::TraverseLaunch a{nodes,
                             static_cast<const float4*>(tris),
                             static_cast<const float*>(orig),
                             static_cast<const float*>(dirn),
                             static_cast<const float*>(max_t),
                             n,
                             any_hit != 0,
                             static_cast<float*>(t_out),
                             static_cast<int*>(slot_out),
                             static_cast<float*>(normal_out),
                             static_cast<int*>(mat_out),
                             nullptr,
                             nullptr};
  return launch_width(a, width, stack, false, static_cast<cudaStream_t>(stream));
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a width or stack capacity that was not compiled.
// ahead_out: null, or at width 8 [9] counts that the visits are added to.
extern "C" int rt_traverse_work(const void* nodes, const void* tris, int width, int stack,
                                const void* orig, const void* dirn, const void* max_t, int n,
                                int any_hit, void* work_out, void* ahead_out, void* stream) {
  if (n <= 0) return 0;
  const rt::TraverseLaunch a{nodes,
                             static_cast<const float4*>(tris),
                             static_cast<const float*>(orig),
                             static_cast<const float*>(dirn),
                             static_cast<const float*>(max_t),
                             n,
                             any_hit != 0,
                             nullptr,
                             nullptr,
                             nullptr,
                             nullptr,
                             static_cast<int*>(work_out),
                             static_cast<unsigned*>(ahead_out)};
  return launch_width(a, width, stack, true, static_cast<cudaStream_t>(stream));
}
