// K3's width-8 instances (render_deferred.cuh), compiled beside the width-4 ones.
#include <cuda_runtime.h>

#include "render_deferred.cuh"

int rt::render_deferred_w8(const DeferredLaunch& a, int stack, cudaStream_t s) {
  return launch_render_deferred<8>(a, stack, s);
}
