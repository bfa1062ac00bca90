"""BSDF direction sampling for the wavefront path tracer.

Material model: metallic > 0.5 -> a mirror lobe widened by roughness,
transmission > 0 -> Fresnel-weighted refraction with the wavelength-
dependent IOR (offsets -0.018, 0, +0.035), otherwise cosine-weighted
Lambertian. Ray-type codes: 0 camera, 1 reflection, 2 transmission,
3 shadow.

Operation order follows the JAX package's XLA path (its `x ** 2` and
`x ** 5` are XLA's multiplication chains x*x and x * ((x*x) * (x*x))), and
the bounce kernel (csrc/bounce.cuh) evaluates the same operations in the
same order.
"""

from __future__ import annotations

import math

import torch

from .linalg import dot, normalize
from .shading import DISPERSION

RAY_CAMERA, RAY_REFLECT, RAY_TRANSMIT, RAY_SHADOW = 0, 1, 2, 3


def orthonormal_basis(n: torch.Tensor):
    """Branchless ONB (Duff et al.) around unit normals [N,3] -> (t, b)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * (nx * nx) * a, s * b, -s * nx], -1)
    u = torch.stack([b, s + (ny * ny) * a, -ny], -1)
    return t, u


def cosine_hemisphere(n: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted directions about unit normals n [N,3]; u1, u2 in [0, 1)."""
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    t, b = orthonormal_basis(n)
    return normalize(t * x[..., None] + b * y[..., None] + n * z[..., None])


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return d - (2.0 * dot(d, n))[..., None] * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Snell refraction of unit d about unit n (facing against d), eta =
    n1/n2 per ray -> (unit direction [N,3], total internal reflection [N])."""
    cos_i = -dot(d, n)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return normalize(torch.where(tir[..., None], reflect(d, n), refr)), tir


def schlick_fresnel(cos_i: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    x = (n1 - n2) / (n1 + n2)
    r0 = x * x
    om = 1.0 - cos_i
    om2 = om * om
    return r0 + (1.0 - r0) * (om * (om2 * om2))


def ior_for_channel(base_ior: torch.Tensor, channel: torch.Tensor) -> torch.Tensor:
    """Wavelength-dependent IOR; a channel >= 3 (full RGB) adds 0."""
    table = torch.tensor(DISPERSION, dtype=base_ior.dtype, device=base_ior.device)
    offs = torch.where(channel < 3, table[torch.clamp(channel, 0, 2)],
                       torch.zeros_like(base_ior))
    return base_ior + offs
