"""PBR material model (struct-of-arrays).

Field for field the JAX package's `Materials`: albedo/emission in f32,
metallic+roughness and ior+transmission f16-packed into one 32-bit word
each (low | high << 16), the KHR specular/volume/spec-gloss fields, a
material_type discriminator and 8 texture-index slots (0xFFFFFFFF = none).
Unsigned 32-bit columns are int64 tensors holding the unsigned value.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.f16 import pack_f16_pair

NO_TEXTURE = np.uint32(0xFFFFFFFF)

# Fixed texture slots of Materials.texture_indices, as the JAX package
# assigns them.
TEX_BASE_COLOR = 0          # baseColorTexture / spec-gloss diffuseTexture
TEX_METALLIC_ROUGHNESS = 1  # metallicRoughnessTexture (B = metallic, G = roughness)
TEX_NORMAL = 2              # normalTexture
TEX_OCCLUSION = 3           # occlusionTexture (R)
TEX_EMISSIVE = 4            # emissiveTexture
TEX_SG_SPECGLOSS = 5        # spec-gloss specularGlossinessTexture


@dataclass
class Materials:
    albedo: torch.Tensor                  # [M,3] f32
    metallic_roughness_f16: torch.Tensor  # [M] u32 value: metallic | roughness<<16
    emission: torch.Tensor                # [M,3] f32
    ior_transmission_f16: torch.Tensor    # [M] u32 value: ior | transmission<<16
    specular_factor: torch.Tensor         # [M] f32
    specular_color: torch.Tensor          # [M,3] f32
    attenuation_distance: torch.Tensor    # [M] f32
    attenuation_color: torch.Tensor       # [M,3] f32
    thickness_factor: torch.Tensor        # [M] f32
    diffuse_factor: torch.Tensor          # [M,3] f32
    glossiness_factor: torch.Tensor       # [M] f32
    material_type: torch.Tensor           # [M] u32 value: 0=metallic-roughness 1=spec-gloss
    texture_indices: torch.Tensor         # [M,8] u32 value
    # which texture slots any material uses (() for untextured scenes)
    present_slots: tuple = ()

    @property
    def count(self) -> int:
        return self.albedo.shape[0]


def _column(rows: list[dict], key: str) -> torch.Tensor:
    col = np.stack([r[key] for r in rows])
    if col.dtype == np.uint32:
        col = col.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(col))


class MaterialBuilder:
    """Host-side accumulator producing a `Materials` SoA."""

    def __init__(self):
        self._rows: list[dict] = []

    def __len__(self) -> int:
        return len(self._rows)

    def add(self, albedo=(1.0, 1.0, 1.0), metallic: float = 0.0,
            roughness: float = 1.0, emission=(0.0, 0.0, 0.0), ior: float = 1.5,
            transmission: float = 0.0, specular_factor: float = 1.0,
            specular_color=(1.0, 1.0, 1.0),
            attenuation_distance: float = float("inf"),
            attenuation_color=(1.0, 1.0, 1.0), thickness_factor: float = 0.0,
            diffuse_factor=None, glossiness_factor=None,
            material_type: int = 0, texture_indices=None) -> int:
        """diffuse_factor defaults to albedo, glossiness to 1 - roughness
        (the f16-quantised roughness, as the JAX package derives it)."""
        self._rows.append(dict(
            albedo=np.asarray(albedo, np.float32),
            metallic_roughness_f16=pack_f16_pair(metallic, roughness),
            emission=np.asarray(emission, np.float32),
            ior_transmission_f16=pack_f16_pair(ior, transmission),
            specular_factor=np.float32(specular_factor),
            specular_color=np.asarray(specular_color, np.float32),
            attenuation_distance=np.float32(attenuation_distance),
            attenuation_color=np.asarray(attenuation_color, np.float32),
            thickness_factor=np.float32(thickness_factor),
            diffuse_factor=np.asarray(
                albedo if diffuse_factor is None else diffuse_factor, np.float32),
            glossiness_factor=np.float32(
                (1.0 - np.float32(np.float16(roughness)))
                if glossiness_factor is None else glossiness_factor),
            material_type=np.uint32(material_type),
            texture_indices=np.full(8, NO_TEXTURE, np.uint32)
            if texture_indices is None
            else np.asarray(texture_indices, np.uint32),
        ))
        return len(self._rows) - 1

    def add_diffuse(self, albedo) -> int:
        return self.add(albedo=albedo, metallic=0.0, roughness=1.0)

    def add_metallic(self, albedo, roughness: float) -> int:
        return self.add(albedo=albedo, metallic=1.0, roughness=roughness)

    def add_glass(self, albedo, ior: float, transmission: float) -> int:
        return self.add(albedo=albedo, metallic=0.0, roughness=0.0, ior=ior,
                        transmission=transmission)

    def add_emissive(self, albedo, emission) -> int:
        return self.add(albedo=albedo, metallic=0.0, roughness=1.0, emission=emission)

    def build(self) -> Materials:
        if not self._rows:
            # keep one (magenta "invalid") material so shading never
            # indexes an empty table
            self.add(albedo=(1.0, 0.0, 1.0))
        cols = {k: _column(self._rows, k) for k in self._rows[0]}
        ti = np.stack([r["texture_indices"] for r in self._rows])
        present = tuple(s for s in range(8) if (ti[:, s] != NO_TEXTURE).any())
        return Materials(**cols, present_slots=present)
