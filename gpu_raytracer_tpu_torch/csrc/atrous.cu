// The edge-avoiding à-trous filter (ops/cuda/denoise.py): a prepare launch
// and one launch a pass.
//
// Replaces no TPU kernel: the JAX package's filter
// (gpu_raytracer_tpu/ops/denoise.py::atrous_denoise) is plain JAX, 25 static
// shifted slices a pass that XLA fuses into one loop. The port's plain
// version (ops/denoise.py) stacks those 25 shifted views of a [H,W,9] field
// into one [25,H,W,9] tensor a pass (943 MB at 1024^2) and reduces it through
// ~40 full-size elementwise intermediates: several GB of device traffic and
// ~140 launches a 3-pass frame, ~16 ms of the path-traced fly frame's 18 ms
// on an H100 (PERF.md).
//
// What bounds it on an H100: the arithmetic of 25 taps a pixel and pass (two
// divisions, one expf, the cosine power's six squarings, ~60
// instructions a tap), not bytes: the field is 32 bytes a pixel, read about
// once a pass (1.7 staged points a pixel), and the planes of a 1024^2 frame
// (48 MB) stay in the 50 MB L2 between passes. So each block stages its
// tile's field in shared memory once, each thread sums its pixel's 25 taps
// from there in registers, and the pass writes only the next pass's colour
// plane (atrous.cuh: the lattice tiling that keeps the halo the same share
// of the tile at every dilation, and the arithmetic). The cosine power's
// exponent 64 (every caller's default) is a template instance whose
// squarings unroll; other exponents take the loop or powf. The depth scale
// is torch.quantile's 99th percentile of a strided subsample of the hit
// depths: the prepare launch writes the subsample, torch.sort orders it, and
// each pass block takes the rank's two order statistics and their lerp from
// the sorted subsample as it starts (atrous.cuh sorted_quantile).
#include <climits>

#include <cuda_runtime.h>

#include "atrous.cuh"

namespace {

using namespace rt::atrous;

// a float tensor's pixel p, channel 0, at a stride of `stride` floats a pixel
__device__ __forceinline__ const float* pixel(const float* base, long long p, int stride) {
  return base + p * stride;
}

constexpr int kPrepareBlock = 256;

__global__ void __launch_bounds__(kPrepareBlock)
atrous_prepare_kernel(const float* __restrict__ color, int color_stride,
                      const float* __restrict__ normal, int normal_stride,
                      const float* __restrict__ depth, int depth_stride,
                      const float* __restrict__ albedo, int albedo_stride, int height, int width,
                      int sub_y, int sub_x, int sub_w, float4* __restrict__ c_plane,
                      float4* __restrict__ g_plane, float* __restrict__ sub_depth,
                      float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * kPrepareBlock + threadIdx.x;
  if (p >= static_cast<long long>(height) * width) return;
  const float* alb = albedo != nullptr ? pixel(albedo, p, albedo_stride) : nullptr;
  const float d = __ldg(pixel(depth, p, depth_stride));
  float4 c, g;
  const bool hit = prepare_pixel(pixel(color, p, color_stride), pixel(normal, p, normal_stride),
                                 d, alb, &c, &g);
  if (out != nullptr) {   // no pass: the frame is the prepare step's colour remodulated
    remodulate(c, alb, out + 3 * p);
    return;
  }
  c_plane[p] = c;
  g_plane[p] = g;
  // the strided subsample the depth scale is the quantile of:
  // where(hit, depth, 0)[::sub_y, ::sub_x]
  const int y = static_cast<int>(p / width), x = static_cast<int>(p % width);
  if (y % sub_y == 0 && x % sub_x == 0) sub_depth[(y / sub_y) * sub_w + x / sub_x] = hit ? d : 0.0f;
}

template <int E>
__global__ void __launch_bounds__(kBlock)
atrous_pass_kernel(const float4* __restrict__ c_in, const float4* __restrict__ g_plane,
                   const float* __restrict__ sorted_sub, int n_sub, PassParams p,
                   float4* __restrict__ c_out, const float* __restrict__ albedo,
                   int albedo_stride, float* __restrict__ out) {
  __shared__ float4 sc[kStage];
  __shared__ float4 sg[kStage];
  __shared__ unsigned char sh[kStage];
  const int H = p.height, W = p.width, s = p.step;
  const Tile t = block_tile(static_cast<int>(blockIdx.x), H, W, s);
  const float zscale = depth_scale(sorted_quantile(sorted_sub, n_sub));
  for (int e = threadIdx.x; e < kStage; e += kBlock) {
    const int q = stage_pixel(t, e, H, W, s);
    bool hit;
    sc[e] = __ldg(c_in + q);
    sg[e] = stage_geometry(__ldg(g_plane + q), zscale, &hit);
    sh[e] = hit ? 1 : 0;
  }
  __syncthreads();
  const int i = threadIdx.x / kTileW, j = threadIdx.x % kTileW;
  const int q = thread_pixel(t, i, j, H, W, s);
  if (q < 0) return;
  const float4 c = filter_pixel<E>(sc, sg, sh, i, j, p);
  if (out == nullptr) {
    c_out[q] = c;
  } else {
    remodulate(c, albedo != nullptr ? pixel(albedo, q, albedo_stride) : nullptr, out + 3 * q);
  }
}

}  // namespace

// The prepare step of an H x W frame: color, normal and albedo (null: no
// demodulation) [H*W,3] f32 and depth [H*W] f32, pixel p's channel 0 at
// p * stride floats, channels next to each other. Writes the planes
// c_plane = (c.xyz, lum) and g_plane = (n.xyz, depth) ([H*W] float4 each)
// and sub_depth [ceil(H / sub_y) * ceil(W / sub_x)], the hit depths (0 for a
// miss) of every sub_y-th row and sub_x-th column; or, with `out` non-null
// (a call of no pass), only out [H*W,3] = the demodulated colour
// remodulated. One launch. Returns cudaGetLastError() after it (0 =
// launched), or cudaErrorInvalidValue for a frame past int32 thread indices.
extern "C" int rt_atrous_prepare(const void* color, int color_stride, const void* normal,
                                 int normal_stride, const void* depth, int depth_stride,
                                 const void* albedo, int albedo_stride, int height, int width,
                                 int sub_y, int sub_x, void* c_plane, void* g_plane,
                                 void* sub_depth, void* out, void* stream) {
  const long long n = static_cast<long long>(height) * width;
  if (height < 0 || width < 0 || sub_y < 1 || sub_x < 1 || n > INT_MAX - kPrepareBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int sub_w = (width + sub_x - 1) / sub_x;
  atrous_prepare_kernel<<<static_cast<unsigned>((n + kPrepareBlock - 1) / kPrepareBlock),
                          kPrepareBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(color), color_stride, static_cast<const float*>(normal),
      normal_stride, static_cast<const float*>(depth), depth_stride,
      static_cast<const float*>(albedo), albedo_stride, height, width, sub_y, sub_x, sub_w,
      static_cast<float4*>(c_plane), static_cast<float4*>(g_plane),
      static_cast<float*>(sub_depth), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One pass at dilation `step` over the planes of rt_atrous_prepare: reads
// c_in and g_plane and the prepare step's depth subsample sorted ascending,
// sorted_sub [n_sub] (n_sub >= 1; the scale is its 99th percentile + 1e-6),
// writes the next pass's c_out, or, with `out` non-null (the last pass),
// out [H*W,3] = the filtered colour remodulated by albedo (null: none; pixel
// stride albedo_stride floats). power: sigma_normal when it is an integer in
// [1, 4096], else 0 (powf). Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a step below 1, an empty
// subsample or a grid past 2^31 - 1 blocks.
extern "C" int rt_atrous_pass(const void* c_in, const void* g_plane, const void* sorted_sub,
                              int n_sub, int height, int width, int step, float sigma_color,
                              float sigma_depth, float sigma_normal, int power, void* c_out,
                              const void* albedo, int albedo_stride, void* out, void* stream) {
  if (height < 0 || width < 0 || step < 1 || step > (1 << 23) || height > (1 << 30) ||
      width > (1 << 30) || static_cast<long long>(height) * width > INT_MAX || n_sub < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = pass_blocks(height, width, step);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const PassParams p{height, width, step, sigma_color, sigma_depth, sigma_normal, power,
                     reciprocal(sigma_color), reciprocal(sigma_depth)};
  const auto* ci = static_cast<const float4*>(c_in);
  const auto* g = static_cast<const float4*>(g_plane);
  const auto* q = static_cast<const float*>(sorted_sub);
  auto* co = static_cast<float4*>(c_out);
  const auto* a = static_cast<const float*>(albedo);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (power == 64)
    atrous_pass_kernel<64><<<grid, kBlock, 0, s>>>(ci, g, q, n_sub, p, co, a, albedo_stride, o);
  else
    atrous_pass_kernel<0><<<grid, kBlock, 0, s>>>(ci, g, q, n_sub, p, co, a, albedo_stride, o);
  return static_cast<int>(cudaGetLastError());
}
