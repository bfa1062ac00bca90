// K6's textured width-8 instances (the kernel is in bounce.cuh, the entry
// point in bounce.cu).
#include <cuda_runtime.h>

#include "bounce.cuh"

int rt::launch_bounce_textured_w8(const BounceArgs& a, int stack, int nee, int cont,
                                  cudaStream_t s) {
  return launch_bounce<8, true>(a, stack, nee, cont, s);
}
