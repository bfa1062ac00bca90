// K3's per-frame pre-pass: the camera-relative node and triangle tables that
// K3's camera walk reads (render_deferred.cuh, traverse.cuh walk_bvh REL).
//
// Part of the port of K3, the TPU kernel gpu_raytracer_tpu/ops/pallas/render.py
// pallas_render_deferred -> _kernel_deferred (pallas_call at :787), which has
// no such pass: its packets compute these terms per ray. Every camera ray of a
// frame starts at the camera's position o, so the terms of K1's walk that
// depend on the origin alone are the same for all of them: plane - o for the
// six planes of every child box (traverse.cuh child_entry*), and s = o - v0,
// q = s x e1 and e2 . q for every triangle (leaf_test). This kernel computes
// each once per frame, with the walk's operations on the same operands in the
// same order (built -fmad=false), so each equals the per-ray value bit for
// bit:
//   rel_nodes: Node<W> records laid out as `nodes` (ops/cuda/traverse.py;
//              128-byte aligned, a width-4 record one line, a width-8 one
//              two): the 6W box words are plane - o of their plane's axis,
//              the child codes, the axis and the pad words are copied;
//   rel_tris:  four float4 per triangle slot, from the slot's (v0, e1, e2):
//              (e1, e2 . q), (e2, 0), (s, 0), (q, 0).
// The origin is read from the device camera row (ops/cuda/render.py::
// set_camera rewrites it in place), so the host neither reads nor waits.
//
// What bounds it on an H100: bytes. It reads the node records and 48 bytes a
// triangle slot once and writes the node records and 64 bytes a slot (13.5 MB
// for the 100k-triangle courtyard, ~4 us at 3.35 TB/s), a few operations per
// word. One thread per float4 of the node records, then one per triangle
// slot, so that neighbouring threads load and store neighbouring 16-byte
// words; one launch for both tables.
//
// The camera row itself is written here too, by a second kernel that
// replaces no TPU kernel (the JAX package rebuilds the row with XLA ops): a
// camera move (ops/cuda/render.py::set_camera). Its plain version, PyTorch's
// eager ops (two cross products, a fill, a concatenation, a copy, and an
// upload of the host camera), is ~20 small device operations, whose host
// dispatch took most of an interactive frame (PERF.md, "Where the time
// goes"). What bounds the kernel is its launch alone: one thread writes 26
// words. So a move is one launch and nothing else on the device: the fields
// of a camera on the host come in as arguments by value, those of a camera
// on the card through their device pointers, and the thread writes the row
// (camera_row.cuh) in place and the camera's 10 fields into a fresh buffer,
// which the scene's camera then views.
#include <climits>

#include <cuda_runtime.h>

#include "camera_row.cuh"

namespace {

constexpr int kBlock = 256;

template <int W>
__global__ void __launch_bounds__(kBlock)
camera_relative_kernel(const float* __restrict__ cam, const float4* __restrict__ nodes,
                       int node_words4, const float4* __restrict__ tris, int n_slots,
                       float4* __restrict__ rel_nodes, float4* __restrict__ rel_tris) {
  constexpr int P = W / 4;    // float4 per box plane of a record
  constexpr int R = 2 * W;    // float4 per record
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float ox = __ldg(cam), oy = __ldg(cam + 1), oz = __ldg(cam + 2);
  if (i < node_words4) {
    const int j = i % R;   // the float4 of its record: planes lo_x .. hi_z, then codes, axis
    float4 v = __ldg(nodes + i);
    if (j < 6 * P) {
      const int axis = (j / P) % 3;
      const float o = axis == 0 ? ox : axis == 1 ? oy : oz;
      v = make_float4(v.x - o, v.y - o, v.z - o, v.w - o);
    }
    rel_nodes[i] = v;
    return;
  }
  const int k = i - node_words4;
  if (k >= n_slots) return;
  const float4 a0 = __ldg(tris + 3 * k + 0);   // v0, material
  const float4 a1 = __ldg(tris + 3 * k + 1);   // e1
  const float4 a2 = __ldg(tris + 3 * k + 2);   // e2
  // leaf_test's s = o - v0, q = s x e1 and e2 . q, in its order
  const float sx = ox - a0.x, sy = oy - a0.y, sz = oz - a0.z;
  const float qx = sy * a1.z - sz * a1.y;
  const float qy = sz * a1.x - sx * a1.z;
  const float qz = sx * a1.y - sy * a1.x;
  const float e2q = a2.x * qx + a2.y * qy + a2.z * qz;
  float4* out = rel_tris + 4 * k;
  out[0] = make_float4(a1.x, a1.y, a1.z, e2q);
  out[1] = make_float4(a2.x, a2.y, a2.z, 0.0f);
  out[2] = make_float4(sx, sy, sz, 0.0f);
  out[3] = make_float4(qx, qy, qz, 0.0f);
}

// The new camera: position, direction, up and fov, each read from its device
// words where `field` gives them (a camera on the card), else from `value`
// (a camera on the host, passed with the launch).
struct CameraSource {
  const float* field[4];
  float value[rt::kCameraFields];
};

// One thread: every source word read before any word is written (a source
// may be a view of the row it replaces), then the row and the fields.
__global__ void __launch_bounds__(1) camera_row_kernel(CameraSource src, float fov_scale,
                                                       float* row, float* fields) {
  float cam[rt::kCameraFields];
#pragma unroll
  for (int k = 0; k < rt::kCameraFields; ++k) {
    const int f = k < 9 ? k / 3 : 3;
    const float* p = src.field[f];
    cam[k] = p != nullptr ? p[k - 3 * f] : src.value[k];
  }
  rt::camera_row(cam, fov_scale, row);
#pragma unroll
  for (int k = 0; k < rt::kCameraFields; ++k) fields[k] = cam[k];
}

}  // namespace

// The camera row ([16] f32, `row`, rewritten in place) and the camera's
// fields ([10] f32, `fields`) of a camera whose position, direction, up
// and fov lie at the device pointers `position`, `direction`, `up`, `fov`,
// or, where a pointer is null, are the values p0-p2, d0-d2, u0-u2, fov_deg;
// `fov_scale` is the row's tan(fov/2), evaluated on the host. One launch
// of one thread. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_camera_row(const void* position, const void* direction, const void* up,
                             const void* fov, float p0, float p1, float p2, float d0, float d1,
                             float d2, float u0, float u1, float u2, float fov_deg,
                             float fov_scale, void* row, void* fields, void* stream) {
  CameraSource src{{static_cast<const float*>(position), static_cast<const float*>(direction),
                    static_cast<const float*>(up), static_cast<const float*>(fov)},
                   {p0, p1, p2, d0, d1, d2, u0, u1, u2, fov_deg}};
  camera_row_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      src, fov_scale, static_cast<float*>(row), static_cast<float*>(fields));
  return static_cast<int>(cudaGetLastError());
}

// The camera-relative tables of the camera row `cam` (position in words
// 0-2) for `n_nodes` node records of `node_width` children and `n_slots`
// triangle rows, into `rel_nodes` ([n_nodes, 8 * node_width] f32) and
// `rel_tris` ([n_slots, 16] f32). Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for another width or
// tables past int32 thread indices.
extern "C" int rt_camera_relative(const void* cam, const void* nodes, int node_width,
                                  int n_nodes, const void* tris, int n_slots, void* rel_nodes,
                                  void* rel_tris, void* stream) {
  if (node_width != 4 && node_width != 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long node_words4 = static_cast<long long>(n_nodes) * 2 * node_width;
  const long long threads = node_words4 + n_slots;
  if (n_nodes < 0 || n_slots < 0 || threads > INT_MAX - kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads == 0) return 0;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cam);
  const auto* nd = static_cast<const float4*>(nodes);
  const auto* tr = static_cast<const float4*>(tris);
  auto* rn = static_cast<float4*>(rel_nodes);
  auto* rtr = static_cast<float4*>(rel_tris);
  if (node_width == 4)
    camera_relative_kernel<4><<<grid, kBlock, 0, s>>>(c, nd, static_cast<int>(node_words4), tr,
                                                      n_slots, rn, rtr);
  else
    camera_relative_kernel<8><<<grid, kBlock, 0, s>>>(c, nd, static_cast<int>(node_words4), tr,
                                                      n_slots, rn, rtr);
  return static_cast<int>(cudaGetLastError());
}
