"""Camera ray generation: pixel-centre (or jittered) UVs, aspect x tan(fov/2)
scaling, camera basis right = forward x up and true_up = right x forward
(neither normalised, as the reference does), direction normalised at the
end."""

from __future__ import annotations

import torch

from ..models.camera import Camera
from .linalg import cross, normalize


def generate_rays(camera: Camera, width: int, height: int,
                  px: torch.Tensor, py: torch.Tensor,
                  jitter: torch.Tensor | None = None, fov_scale: float | None = None):
    """px, py: [N] integer pixel coordinates -> (origins [N,3], unit
    directions [N,3]) on the pixels' device. `jitter` [N,2] in [0, 1)
    replaces the +0.5 pixel centre (anti-aliasing samples). `fov_scale` is
    the camera's tan(fov/2) when the caller has it already
    (`Camera.fov_scale()` reads the field of view back to the host)."""
    f32 = torch.float32
    # divisors as tensors: PyTorch's CUDA kernels would turn a division by a
    # Python scalar into a multiply by its reciprocal. torch.full, not
    # torch.tensor: no host-to-device copy, which would wait for the device.
    w = torch.full((), width, dtype=f32, device=px.device)
    h = torch.full((), height, dtype=f32, device=px.device)
    if jitter is None:
        u = (px.to(f32) + 0.5) / w
        v = (py.to(f32) + 0.5) / h
    else:
        u = (px.to(f32) + jitter[:, 0]) / w
        v = (py.to(f32) + jitter[:, 1]) / h
    aspect = w / h
    if fov_scale is None:
        fov_scale = camera.fov_scale()
    cx = (u * 2.0 - 1.0) * aspect * fov_scale
    cy = (1.0 - v * 2.0) * fov_scale
    forward = camera.direction.to(px.device)
    right = cross(forward, camera.up.to(px.device))
    true_up = cross(right, forward)
    d = normalize(forward + right * cx[:, None] + true_up * cy[:, None])
    o = camera.position.to(px.device).expand_as(d)
    return o, d


def pixel_grid(width: int, height: int, device="cpu"):
    """The full frame's pixel coordinates, row-major -> (px [H*W] i32,
    py [H*W] i32) on `device`."""
    grid = torch.arange(width * height, dtype=torch.int32, device=device)
    return grid % width, grid // width
