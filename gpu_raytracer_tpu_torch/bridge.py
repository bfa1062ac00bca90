"""Scene <-> flat dict of NumPy arrays.

A scene prepared elsewhere (the JAX package's, handed over as NumPy arrays
under the same field names) becomes this package's `Scene` on any device:
the scene tables are this system's "weights carried across". The keys are
"<group>.<field>" for nested dataclasses ("bvh.q_child", "camera.fov") and
the plain field name for top-level tensors ("tri_v0"); integer metadata
(`bvh.leaf_align`, `bvh.max_leaf`, `bvh.depth`, `textures.n_levels`, ...)
travels as 0-d arrays, tuples (`materials.present_slots`) as tuples. Textured
scenes carry their atlas (`textures.*`, texels as unsigned values in int64);
the per-slot uv-density code is derived from the carried triangle tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.bvh import Bvh
from .models.camera import Camera
from .models.geometry import Mesh, Spheres, Textures
from .models.light import Lights
from .models.material import Materials
from .models.scene import Scene
from .ops.texture import uv_density_code

GROUPS = {"camera": Camera, "spheres": Spheres, "mesh": Mesh,
          "materials": Materials, "lights": Lights, "textures": Textures,
          "bvh": Bvh}
TOP_LEVEL = ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "tri_uv", "tri_src")

# dtypes of this package's tensors; unsigned 32-bit columns are int64
_INT64 = {"spheres.material_id", "mesh.indices", "mesh.material_id",
          "materials.metallic_roughness_f16", "materials.ior_transmission_f16",
          "materials.material_type", "materials.texture_indices",
          "lights.light_type", "lights.range_packed", "lights.cone_angles_packed"}


def _tensor(key: str, a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if key in _INT64 or key.startswith("textures."):
        dtype = np.int64
    else:
        dtype = np.float32 if a.dtype.kind == "f" else np.int32
    return torch.from_numpy(np.array(a, dtype=dtype))   # a writable copy, 0-d kept


def _meta(v):
    if isinstance(v, np.ndarray) and v.ndim == 0:
        v = v.item()
    return tuple(int(x) for x in v) if isinstance(v, (tuple, list, np.ndarray)) else v


def scene_from_arrays(arrays: dict[str, np.ndarray], device) -> Scene:
    """Build a `Scene` on `device` from a flat dict of NumPy arrays."""
    groups = {}
    for name, cls in GROUPS.items():
        kw = {}
        for f in dataclasses.fields(cls):
            key = f"{name}.{f.name}"
            if key not in arrays:
                continue
            v = arrays[key]
            if "Tensor" in f.type:
                kw[f.name] = None if v is None else _tensor(key, v)
            else:
                kw[f.name] = _meta(v)
        groups[name] = cls(**kw)
    top = {k: _tensor(k, arrays[k]) for k in TOP_LEVEL}
    den = uv_density_code(top["tri_e1"], top["tri_e2"], top["tri_uv"])
    return Scene(**groups, **top, tri_den=den).to(device)


def scene_to_arrays(scene: Scene) -> dict[str, np.ndarray]:
    """The inverse: every tensor as a NumPy array, metadata as 0-d arrays or
    tuples, under the keys `scene_from_arrays` reads."""
    out = {}
    for name in GROUPS:
        obj = getattr(scene, name)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f"{name}.{f.name}"] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                                       else v if v is None or isinstance(v, tuple)
                                       else np.asarray(v))
    for k in TOP_LEVEL:
        out[k] = getattr(scene, k).cpu().numpy()
    return out
