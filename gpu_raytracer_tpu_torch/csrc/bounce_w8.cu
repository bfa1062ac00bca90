// K6's untextured width-8 instances (the kernel is in bounce.cuh, the entry
// point in bounce.cu).
#include <cuda_runtime.h>

#include "bounce.cuh"

int rt::launch_bounce_w8(const BounceArgs& a, int stack, int nee, int cont, cudaStream_t s) {
  return launch_bounce<8, false>(a, stack, nee, cont, s);
}
