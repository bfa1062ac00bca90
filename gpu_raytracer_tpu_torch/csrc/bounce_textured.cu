// K6's textured instances (the kernel is in bounce.cuh, the entry point in
// bounce.cu): the hit's uv and K5's material sample at the launch's mip level.
#include <cuda_runtime.h>

#include "bounce.cuh"

int rt_bounce_textured_launch(const rt::BounceArgs& a, int stack, int nee, int cont,
                              cudaStream_t s) {
  return rt::launch_bounce<true>(a, stack, nee, cont, s);
}
