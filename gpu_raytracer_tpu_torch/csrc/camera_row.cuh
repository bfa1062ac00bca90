// The camera row that K2, K2t, K3 and K3's pre-pass read (render_common.cuh
// camera ray, camera_relative.cu), from the camera's fields: 16 words,
// position, forward, right = forward x up, true_up = right x forward, the
// camera's tan(fov/2), 3 zeros. Each cross product takes the operations and
// the order of ops/linalg.py::cross (a1*b2 - a2*b1, each product rounded on
// its own: built -fmad=false, or -ffp-contract=off on the host), so the row
// equals the plain version, ops/cuda/render.py::camera_row, bit for bit.
// Kept apart from its kernel (camera_relative.cu rt_camera_row) so that the
// same function also compiles for the host (tests/test_torch_camera_row.py
// builds it with g++ and holds it to the plain version).
#pragma once

namespace rt {

constexpr int kCameraFields = 10;   // position, direction, up, fov (degrees)
constexpr int kCameraRowWords = 16;

__host__ __device__ inline void camera_row(const float* cam, float fov_scale, float* row) {
  const float px = cam[0], py = cam[1], pz = cam[2];
  const float dx = cam[3], dy = cam[4], dz = cam[5];
  const float ux = cam[6], uy = cam[7], uz = cam[8];
  const float rx = dy * uz - dz * uy;   // right = direction x up
  const float ry = dz * ux - dx * uz;
  const float rz = dx * uy - dy * ux;
  const float tx = ry * dz - rz * dy;   // true_up = right x direction
  const float ty = rz * dx - rx * dz;
  const float tz = rx * dy - ry * dx;
  const float words[kCameraRowWords] = {px, py, pz, dx, dy, dz, rx, ry, rz,
                                        tx, ty, tz, fov_scale, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < kCameraRowWords; ++k) row[k] = words[k];
}

}  // namespace rt
