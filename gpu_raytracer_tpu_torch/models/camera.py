"""Camera model + interactive controller.

Pinhole camera with the JAX package's field semantics and its WASD/mouse
controller; the fields are float32 tensors on the scene's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RaytracerConfig


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


@dataclass
class Camera:
    position: torch.Tensor   # [3] f32
    direction: torch.Tensor  # [3] f32 (unit)
    up: torch.Tensor         # [3] f32 (unit)
    fov: torch.Tensor        # [] f32, vertical FOV in degrees

    @staticmethod
    def default() -> "Camera":
        """Position (0,0,5), looking down -Z, +Y up, 45 degrees."""
        return Camera(position=_f32([0.0, 0.0, 5.0]),
                      direction=_f32([0.0, 0.0, -1.0]),
                      up=_f32([0.0, 1.0, 0.0]),
                      fov=_f32(45.0))

    @staticmethod
    def create(position, direction, up=(0.0, 1.0, 0.0), fov=45.0) -> "Camera":
        # idempotent f64 normalisation: an already-unit direction passes
        # through bit-unchanged
        d64 = np.asarray(direction, np.float64)
        n = float(np.linalg.norm(d64))
        if n == 0.0 or abs(n - 1.0) <= 1e-6:
            d = np.asarray(direction, np.float32)
        else:
            d = (d64 / n).astype(np.float32)
        return Camera(position=_f32(position), direction=_f32(d),
                      up=_f32(up), fov=_f32(fov))

    def to(self, device) -> "Camera":
        """The camera on `device`. A camera move on CUDA tables takes no copy
        (ops/cuda/render.py::set_camera writes the fields on the card)."""
        return Camera(*(f.to(device) for f in (self.position, self.direction, self.up, self.fov)))

    def fov_scale(self) -> float:
        """tan(fov/2) as a float32 value, evaluated once on the host so that
        every device and kernel scales rays by the same number."""
        return tan_half_fov(self.fov)


def tan_half_fov(fov) -> float:
    """tan(fov/2) of a field of view in degrees (a tensor on any device, read
    back to the host, or a number), evaluated in float32 on the host."""
    fov = torch.as_tensor(fov).detach().to("cpu", torch.float32)
    return float(torch.tan(fov * 0.5 * math.pi / 180.0))


class CameraController:
    """Host-side interactive camera: yaw about +Y on the XZ components,
    clamped pitch on Y followed by renormalisation, movement along
    ``direction`` and ``right = direction x up``."""

    def __init__(self, camera: Camera, config: RaytracerConfig = DEFAULT_CONFIG):
        self.position = camera.position.cpu().numpy().astype(np.float32).copy()
        self.direction = camera.direction.cpu().numpy().astype(np.float32).copy()
        self.up = camera.up.cpu().numpy().astype(np.float32).copy()
        self.fov = float(camera.fov)
        self.config = config

    def rotate(self, dx: float, dy: float) -> None:
        sens = self.config.camera_rotate_sensitivity
        yaw = -dx * sens
        pitch = -dy * sens
        cos_y, sin_y = math.cos(yaw), math.sin(yaw)
        x, y, z = self.direction
        self.direction = np.asarray(
            [x * cos_y - z * sin_y, y, x * sin_y + z * cos_y], np.float32)
        clamp = self.config.camera_pitch_clamp
        self.direction[1] = float(np.clip(self.direction[1] + pitch, -clamp, clamp))
        self.direction /= np.linalg.norm(self.direction)

    def move(self, forward: float = 0.0, strafe: float = 0.0) -> None:
        speed = self.config.camera_move_speed
        right = np.cross(self.direction, self.up)
        n = np.linalg.norm(right)
        if n > 0:
            right = right / n
        self.position = (self.position + self.direction * (forward * speed)
                         + right * (strafe * speed)).astype(np.float32)

    def camera(self) -> Camera:
        return Camera(position=_f32(self.position), direction=_f32(self.direction),
                      up=_f32(self.up), fov=_f32(self.fov))
