"""Shading: Whitted-style direct lighting + material and texture evaluation.

  * textures multiply the material factors: base colour the albedo,
    emissive the emission, metallic-roughness's B channel the metallic,
    occlusion's R channel the ambient term (only the slots some material
    uses are sampled);
  * ambient 0.1 x albedo, per-light N.L, branchless light-type blend;
  * distance attenuation 1/(1 + 0.01 d^2) round-tripped through f16;
  * BRDF: metallic > 0.5 -> 0.5 albedo I, else (albedo / pi) I;
  * wavelength-dependent IOR dispersion (-0.018, 0, +0.035) and the
    transmission blend with (0.2, 0.2, 0.3), all three channels at once;
  * magenta for an invalid material, the sky colour for a miss.

`shade_deferred` is the second half of the two-phase textured render: it
takes a per-ray light sum S (shadowed, material-independent) and computes
albedo*0.1*occ + (albedo*brdf)*S + emission, the same sum as
`direct_lighting` refactored over the lights.

Every light is evaluated, in light order, unless a caller passes
`light_index` [N]: then each ray evaluates only the light it names and
weights it by the light count, an unbiased estimate of the sum (the
single-sample branch the render kernels take above MAX_LIGHTS lights).

Every division here is tensor by tensor: PyTorch's CUDA kernels turn a
division by a Python scalar into a multiplication by its reciprocal, which
would round differently from the CPU and from the CUDA render kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.material import (TEX_BASE_COLOR, TEX_EMISSIVE, TEX_METALLIC_ROUGHNESS,
                               TEX_OCCLUSION)
from ..models.scene import Scene
from .f16 import f16_roundtrip, unpack_f16_high, unpack_f16_low
from .linalg import dot, max0, normalize
from .texture import den_decode, sample_texture
from .trace import TRIANGLE, Hit

MAGENTA = (1.0, 0.0, 1.0)
DISPERSION = (-0.018, 0.0, 0.035)
TRANSMITTED_BASE = (0.2, 0.2, 0.3)


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _material_maps(scene: Scene, mid: torch.Tensor, uv: torch.Tensor,
                   lam: torch.Tensor | None, trilinear: bool, lod: float | None):
    """Material rows of clipped ids `mid` with their texture factors applied,
    each used map sampled once -> (albedo [N,3], emission [N,3], metallic
    [N], roughness [N], occlusion [N] or None)."""
    m = scene.materials
    albedo = m.albedo[mid]
    emission = m.emission[mid]
    metallic = unpack_f16_low(m.metallic_roughness_f16[mid])
    roughness = unpack_f16_high(m.metallic_roughness_f16[mid])
    occlusion = None
    if scene.textures.textured:
        tex = scene.textures
        ti = m.texture_indices[mid]
        slots = m.present_slots
        lod_t = (None if lod is None or tex.n_levels <= 1
                 else torch.full(mid.shape, float(lod), dtype=uv.dtype, device=uv.device))
        sample = lambda slot: sample_texture(tex, ti[:, slot], uv, lam=lam,
                                             trilinear=trilinear, lod=lod_t)
        if TEX_BASE_COLOR in slots:
            albedo = albedo * sample(TEX_BASE_COLOR)[:, :3]
        if TEX_EMISSIVE in slots:
            emission = emission * sample(TEX_EMISSIVE)[:, :3]
        if TEX_METALLIC_ROUGHNESS in slots:
            mr = sample(TEX_METALLIC_ROUGHNESS)
            metallic = metallic * mr[:, 2]      # B channel
            roughness = roughness * mr[:, 1]    # G channel
        if TEX_OCCLUSION in slots:
            occlusion = sample(TEX_OCCLUSION)[:, 0]
    return albedo, emission, metallic, roughness, occlusion


def material_textures(scene: Scene, mid: torch.Tensor, uv: torch.Tensor,
                      lam: torch.Tensor | None = None, trilinear: bool = False,
                      lod: float | None = None):
    """Material rows of clipped ids `mid` with their texture factors applied
    -> (albedo [N,3], emission [N,3], metallic [N], occlusion [N] or None).
    `lam` (a mip footprint) and `trilinear` select the level of primary
    shading; `lod` samples every map at that explicit level instead (the
    path tracer's bounce LOD)."""
    albedo, emission, metallic, _, occlusion = _material_maps(scene, mid, uv, lam,
                                                              trilinear, lod)
    return albedo, emission, metallic, occlusion


@dataclass
class MaterialSample:
    """Per-ray material parameters at the hit (the path tracer's 11 channels)."""
    albedo: torch.Tensor               # [N,3]
    emission: torch.Tensor             # [N,3]
    metallic: torch.Tensor             # [N]
    roughness: torch.Tensor            # [N]
    ior: torch.Tensor                  # [N]
    transmission: torch.Tensor         # [N]
    occlusion: torch.Tensor | None     # [N], None when no material has the map


def sample_materials(scene: Scene, mid: torch.Tensor, uv: torch.Tensor,
                     lod: float | None = None) -> MaterialSample:
    """The bounce's material sample at clipped ids `mid` and hit uvs, every
    map at the fixed level `lod` (None: level 0): the plain version of the
    material sampler the bounce kernel calls (csrc/texsample.cuh
    `sample_material`). The metallic-roughness map's B scales metallic and
    its G roughness."""
    albedo, emission, metallic, roughness, occlusion = _material_maps(
        scene, mid, uv, None, False, lod)
    packed = scene.materials.ior_transmission_f16[mid]
    return MaterialSample(albedo, emission, metallic, roughness, unpack_f16_low(packed),
                          unpack_f16_high(packed), occlusion)


def pixel_footprint_scale(fov_scale: float, height: int) -> float:
    """2 tan(fov/2) / height as an f32 value, a pixel's angular size, from
    the camera's tan(fov/2) (`Camera.fov_scale()`)."""
    f = np.float32
    return float(f(2.0) * f(fov_scale) * f(1.0 / height))


def hit_footprint(scene: Scene, hit: Hit, height: int) -> torch.Tensor:
    """Mip footprint [N] of primary hits: t x pixel angular size x the
    winner triangle's decoded uv density; 0 for sphere hits and misses
    (level 0)."""
    i = torch.clamp(hit.prim_id, 0, scene.tri_v0.shape[0] - 1)
    pix = pixel_footprint_scale(scene.camera.fov_scale(), height)
    lam = hit.t * pix * den_decode(scene.tri_den[i])
    return torch.where(hit.hit & (hit.prim_kind == TRIANGLE), lam, torch.zeros_like(lam))


def _brdf_scale(metallic: torch.Tensor) -> torch.Tensor:
    """[N,1]: 0.5 for metals (metallic > 0.5), 1/pi otherwise."""
    is_metal = (metallic > 0.5).to(torch.float32)[:, None]
    pi = torch.tensor(math.pi, dtype=torch.float32, device=is_metal.device)
    return is_metal * 0.5 + (1.0 - is_metal) / pi


def light_rows(x: torch.Tensor, light_index: torch.Tensor | None) -> torch.Tensor:
    """A per-light column [L,...] laid out for broadcasting against per-ray
    values [N,1,...]: every light, [1,L,...], or each ray's own light,
    [N,1,...], when `light_index` [N] names one."""
    return x[None] if light_index is None else x[light_index][:, None]


def sample_light_index(scene: Scene, light_u: torch.Tensor) -> torch.Tensor:
    """[N] the light each ray picks from its uniform: min(floor(u * L), L - 1)."""
    n = scene.lights.count
    return torch.clamp((light_u * n).to(torch.int64), max=n - 1)


def light_intensity(scene: Scene, hit: Hit, shadow_mask: torch.Tensor | None = None,
                    light_index: torch.Tensor | None = None) -> torch.Tensor:
    """[N,L] intensity of each light at the hit points ([N,1], of each ray's
    own light, with `light_index`), times the shadow mask when given, before
    the > 0 contribution gate."""
    L = scene.lights
    n = hit.normal
    p = hit.point
    intensity = light_rows(L.intensity, light_index)

    # normalize() of a zero direction gives NaN, which max0 silences
    ldir = light_rows(normalize(L.direction), light_index)          # [1,L,3]
    dir_I = max0(dot(n[:, None, :], -ldir)) * intensity             # [N,L]

    to_light = light_rows(L.position, light_index) - p[:, None, :]  # [N,L,3]
    dist = torch.sqrt(dot(to_light, to_light))
    pl_dir = to_light / dist[..., None]
    atten = f16_roundtrip(torch.reciprocal(1.0 + dist * dist * 0.01))
    point_I = max0(dot(n[:, None, :], pl_dir)) * intensity * atten
    spot_I = point_I * max0(dot(-ldir, pl_dir))

    lt = light_rows(L.light_type, light_index)
    I = dir_I * (lt == 0) + point_I * (lt == 1) + spot_I * (lt == 2)
    if shadow_mask is not None:
        I = I * shadow_mask
    return I


def light_sum(scene: Scene, hit: Hit, shadow_mask: torch.Tensor | None = None,
              light_index: torch.Tensor | None = None) -> torch.Tensor:
    """[N,3] material-independent light sum S = sum over lights, in light
    order, of (I * gate) * colour; with `light_index` the one sampled light's
    (I * gate) * L * colour; 0 on a miss."""
    I = light_intensity(scene, hit, shadow_mask, light_index)
    Ig = I * (I > 0.0).to(torch.float32)
    color = scene.lights.color
    if light_index is not None:
        S = (Ig * scene.lights.count) * color[light_index]
    else:
        S = Ig[:, 0, None] * color[0][None, :]
        for li in range(1, scene.lights.count):
            S = S + Ig[:, li, None] * color[li][None, :]
    return torch.where(hit.hit[:, None], S, torch.zeros_like(S))


def direct_lighting(scene: Scene, hit: Hit, shadow_mask: torch.Tensor | None = None,
                    lam: torch.Tensor | None = None, trilinear: bool = False,
                    light_index: torch.Tensor | None = None) -> torch.Tensor:
    """Per-ray RGB [N,3] from ambient + punctual lights + emission.
    shadow_mask: optional [N,L] (1 lit, 0 occluded), multiplied into each
    light's intensity before the > 0 contribution gate. `lam` (a mip
    footprint) and `trilinear` select the texture level. `light_index` [N]:
    single-sample light selection (shadow_mask is then [N,1])."""
    mid = torch.clamp(hit.material_id, 0, scene.materials.count - 1)
    albedo, emission, metallic, occlusion = material_textures(
        scene, mid, hit.uv, lam=lam, trilinear=trilinear)
    return lit_by_all_lights(scene, hit, albedo, emission, metallic, occlusion, shadow_mask,
                             light_index)


def lit_by_all_lights(scene: Scene, hit: Hit, albedo, emission, metallic, occlusion,
                      shadow_mask: torch.Tensor | None = None,
                      light_index: torch.Tensor | None = None) -> torch.Tensor:
    """[N,3] ambient + every light in light order + emission, for material
    parameters already sampled at the hits; with `light_index` the one
    sampled light weighted by the light count in place of the sum."""
    L = scene.lights
    I = light_intensity(scene, hit, shadow_mask, light_index)
    brdf_scale = _brdf_scale(metallic)
    gate = (I > 0.0).to(torch.float32)
    if light_index is not None:
        light_total = albedo * brdf_scale * ((I * gate) * L.count) * L.color[light_index]
    else:
        per_light = (albedo[:, None, :] * brdf_scale[..., None]
                     * (I * gate)[..., None] * L.color[None, :, :])     # [N,L,3]
        # the light sum in light order, as the render kernel accumulates it
        light_total = per_light[:, 0]
        for li in range(1, L.count):
            light_total = light_total + per_light[:, li]
    ambient = albedo * 0.1
    if occlusion is not None:
        ambient = ambient * occlusion[:, None]
    return ambient + light_total + emission


def dispersion_blend(scene: Scene, mid: torch.Tensor,
                     lighting: torch.Tensor) -> torch.Tensor:
    """Transmission blend with wavelength-dependent IOR for clipped
    material ids `mid`, all three channels at once."""
    m = scene.materials
    ior = unpack_f16_low(m.ior_transmission_f16[mid])[:, None]     # [N,1]
    trans = torch.clamp(unpack_f16_high(m.ior_transmission_f16[mid]), 0.0, 1.0)[:, None]
    wavelength_ior = ior + _f32(DISPERSION, ior.device)[None, :]    # [N,3]
    dispersion = (wavelength_ior - 1.0) / (ior - 1.0)
    transmitted = _f32(TRANSMITTED_BASE, ior.device)[None, :] * dispersion
    blended = lighting * (1.0 - trans) + transmitted * trans
    return torch.where(trans > 0.0, blended, lighting)


def apply_dispersion(scene: Scene, hit: Hit, lighting: torch.Tensor) -> torch.Tensor:
    mid = torch.clamp(hit.material_id, 0, scene.materials.count - 1)
    return dispersion_blend(scene, mid, lighting)


def shade(scene: Scene, hit: Hit, shadow_mask: torch.Tensor | None = None,
          sky_color=(0.0, 0.0, 0.0), lam: torch.Tensor | None = None,
          trilinear: bool = False, light_index: torch.Tensor | None = None) -> torch.Tensor:
    """Shading for a traced batch -> RGB [N,3]: sky on a miss, magenta for
    an out-of-range material."""
    color = apply_dispersion(scene, hit, direct_lighting(
        scene, hit, shadow_mask, lam=lam, trilinear=trilinear, light_index=light_index))
    invalid = hit.hit & ((hit.material_id < 0)
                         | (hit.material_id >= scene.materials.count))
    dev = color.device
    color = torch.where(invalid[:, None], _f32(MAGENTA, dev)[None, :], color)
    return torch.where(hit.hit[:, None], color, _f32(sky_color, dev)[None, :])


def shade_deferred(scene: Scene, light_sum: torch.Tensor, mat_id: torch.Tensor,
                   uv: torch.Tensor, sky_color=(0.0, 0.0, 0.0),
                   lam: torch.Tensor | None = None, trilinear: bool = False) -> torch.Tensor:
    """Material and texture apply of the two-phase render -> RGB [N,3]:
    light_sum [N,3], mat_id [N] (-1 a miss), uv [N,2], lam [N] the mip
    footprint. The plain version of the texture shade kernel
    (ops/cuda/texshade.py), in the JAX package's XLA order:
    albedo*0.1*occ + (albedo*brdf)*S + emission."""
    hit = mat_id >= 0
    m = scene.materials
    mid = torch.clamp(mat_id, 0, m.count - 1)
    albedo, emission, metallic, occlusion = material_textures(
        scene, mid, uv, lam=lam, trilinear=trilinear)
    ambient = albedo * 0.1
    if occlusion is not None:
        ambient = ambient * occlusion[:, None]
    color = ambient + albedo * _brdf_scale(metallic) * light_sum + emission
    color = dispersion_blend(scene, mid, color)
    dev = color.device
    invalid = hit & (mat_id >= m.count)
    color = torch.where(invalid[:, None], _f32(MAGENTA, dev)[None, :], color)
    return torch.where(hit[:, None], color, _f32(sky_color, dev)[None, :])
