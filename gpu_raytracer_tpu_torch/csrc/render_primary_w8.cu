// K2's width-8 instances (render_primary.cuh), compiled beside the width-4 ones.
#include "render_primary.cuh"

int rt::render_primary_w8(const PrimaryLaunch& a, int stack, cudaStream_t s) {
  return launch_render_primary<8, false>(a, stack, s);
}
