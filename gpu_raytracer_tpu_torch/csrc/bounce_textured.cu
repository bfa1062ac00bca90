// K6's textured width-4 instances (the kernel is in bounce.cuh, the entry
// point in bounce.cu): the hit's uv and K5's material sample at the launch's
// mip level.
#include <cuda_runtime.h>

#include "bounce.cuh"

int rt::launch_bounce_textured(const BounceArgs& a, int stack, int nee, int cont,
                               cudaStream_t s) {
  return launch_bounce<4, true>(a, stack, nee, cont, s);
}
