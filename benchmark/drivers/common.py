"""What every driver shares: the program's scene from the configuration's
inputs, the run's clock and spans, and the frame-completion bookkeeping."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .. import scenes, generator


def make_inputs(config: dict, seed: int) -> scenes.CourtyardInputs:
    """The configuration's scene, its boxes, materials and maps drawn from
    the run's seed: every seed gives the same counts and sizes."""
    s = config["scene"]
    return scenes.courtyard(s["triangles"], seed=generator.scene_seed(seed), lights=s["lights"],
                            textured=s["textured"], texture_size=s.get("texture_size", 128))


def program_config(config: dict):
    from gpu_raytracer_tpu_torch.config import RaytracerConfig

    return RaytracerConfig(**config["program"])


def program_scene(inputs: scenes.CourtyardInputs, rt_config, device,
                  budget_rows: int | None = None):
    """The program's scene from the inputs, through its own builders:
    Mesh.from_arrays, MaterialBuilder, LightBuilder, Camera.create,
    Textures.from_images (the maps' mips within `budget_rows` atlas rows)
    and prepare_scene."""
    from gpu_raytracer_tpu_torch.models.camera import Camera
    from gpu_raytracer_tpu_torch.models.geometry import Mesh, Spheres, Textures
    from gpu_raytracer_tpu_torch.models.light import LightBuilder
    from gpu_raytracer_tpu_torch.models.material import (NO_TEXTURE, TEX_BASE_COLOR,
                                                         MaterialBuilder)
    from gpu_raytracer_tpu_torch.models.scene import prepare_scene

    mats = MaterialBuilder()
    for m in inputs.materials:
        ti = None
        if m.base_map >= 0:
            ti = np.full(8, NO_TEXTURE, np.uint32)
            ti[TEX_BASE_COLOR] = m.base_map
        mats.add(albedo=m.albedo, metallic=m.metallic, roughness=m.roughness, ior=m.ior,
                 transmission=m.transmission, texture_indices=ti)
    lb = LightBuilder()
    for li in inputs.lights:
        if li.kind == "directional":
            lb.add_directional(li.vector, li.color, li.intensity)
        else:
            lb.add_point(li.vector, li.color, li.intensity)
    mesh = Mesh.from_arrays(inputs.vertices, inputs.faces, inputs.material_id, uv=inputs.uv)
    camera = Camera.create(position=inputs.camera_position, direction=inputs.camera_direction,
                           fov=inputs.fov)
    textures = None
    if inputs.images:
        textures = Textures.from_images(inputs.images, mips=rt_config.texture_mips,
                                        budget_rows=budget_rows)
    return prepare_scene(camera, Spheres.from_rows([]), mesh, mats.build(), lb.build(),
                         textures=textures, config=rt_config, device=device)


def scene_tables(inputs: scenes.CourtyardInputs, tree_bytes: int) -> dict:
    """What the rooflines charge for the scene's tables: the reference tree's
    bytes, the material and light rows, and the maps' texels with their mips."""
    return {"tree_bytes": tree_bytes,
            "materials": len(inputs.materials), "lights": len(inputs.lights),
            "texel_bytes": sum(int(im.shape[0]) * int(im.shape[1]) * 4 * 4 // 3
                               for im in inputs.images)}


@dataclass
class Spans:
    """Host spans of the window, kept in memory: name -> durations (s)."""
    on: bool = False
    times: dict = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        if self.on:
            self.times.setdefault(name, []).append(seconds)


now = time.perf_counter


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default), of every value."""
    return float(np.percentile(np.asarray(values, np.float64), q))
