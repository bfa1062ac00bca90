// K1's width-8 instances (traverse_kernels.cuh), in a source of their own so
// that they compile beside the width-4 ones (traverse.cu).
#include <cuda_runtime.h>

#include "traverse_kernels.cuh"

int rt::launch_traverse_w8(const TraverseLaunch& a, int stack, bool work, cudaStream_t s) {
  return launch_traverse<8>(a, stack, work, s);
}
