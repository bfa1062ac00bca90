"""Procedural benchmark scenes: the courtyard, untextured or textured, and
the material zoo.

The courtyard is a tiled floor heightfield, a grid of boxes and two or more
lights, tuned to a target triangle count, with the camera inside. The
textured variant binds procedural RGBA8 maps (checker floor, brick and
plaster boxes) with world-space planar uvs. The zoo is the same box grid
under dozens of materials and textures (`make_zoo_scene`). Deterministic per
seed and identical to the JAX package's `make_courtyard_scene` and
`make_zoo_scene`.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import zipfile

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RaytracerConfig
from ..models.camera import Camera
from ..models.geometry import JAX_ATLAS_BUDGET_ROWS, Mesh, Spheres, Textures
from ..models.light import LightBuilder
from ..models.material import (NO_TEXTURE, TEX_BASE_COLOR, TEX_EMISSIVE,
                               TEX_METALLIC_ROUGHNESS, TEX_OCCLUSION, MaterialBuilder)
from ..models.scene import Scene, prepare_scene

_BOX_FACES = np.asarray([
    [0, 1, 2], [0, 2, 3],  # bottom
    [4, 6, 5], [4, 7, 6],  # top
    [0, 4, 5], [0, 5, 1],  # -z
    [3, 2, 6], [3, 6, 7],  # +z
    [0, 3, 7], [0, 7, 4],  # -x
    [1, 5, 6], [1, 6, 2],  # +x
], np.uint32)

_BOX_CORNERS = np.asarray([
    [0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1],
    [0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1],
], np.float32)


def _boxes(centers, sizes):
    """Vectorised box meshes: centers [B,3], sizes [B,3] -> (verts, faces)."""
    B = centers.shape[0]
    verts = (_BOX_CORNERS[None] - 0.5) * sizes[:, None, :] + centers[:, None, :]
    faces = _BOX_FACES[None] + (np.arange(B, dtype=np.uint32) * 8)[:, None, None]
    return verts.reshape(-1, 3).astype(np.float32), faces.reshape(-1, 3)


def _heightfield(nx, nz, x0, x1, z0, z1, fn):
    xs = np.linspace(x0, x1, nx, dtype=np.float32)
    zs = np.linspace(z0, z1, nz, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = fn(X, Z).astype(np.float32)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(nz - 1), indexing="ij")
    a = (i * nz + j).reshape(-1)
    b = ((i + 1) * nz + j).reshape(-1)
    c = ((i + 1) * nz + j + 1).reshape(-1)
    d = (i * nz + j + 1).reshape(-1)
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    return verts, faces.astype(np.uint32)


def make_checker_texture(size: int = 128, tiles: int = 8,
                         c0=(230, 228, 220), c1=(60, 58, 54)) -> np.ndarray:
    """Checkerboard RGBA8 image [size, size, 4]."""
    ax = ((np.arange(size, dtype=np.int32) * tiles // size) & 1).astype(np.uint8)
    cell = ax[:, None] ^ ax[None, :]
    palette = np.asarray([(*c0, 255), (*c1, 255)], np.uint8)
    return palette[cell]


def make_brick_texture(size: int = 128, rows: int = 8, brick=(180, 96, 70),
                       mortar=(200, 196, 188), seed: int = 0) -> np.ndarray:
    """Running-bond brick RGBA8 image with per-brick tint noise."""
    rng = np.random.default_rng(seed)
    y = np.arange(size)[:, None]
    x = np.arange(size)[None, :]
    bh = size // rows
    bw = bh * 2
    row = y // bh
    xs = x + (row % 2) * (bw // 2)              # running bond offset
    col = xs // bw
    row = np.broadcast_to(row, (size, size))
    xs = np.broadcast_to(xs, (size, size))
    col = np.broadcast_to(col, (size, size))
    in_mortar = ((y % bh) < max(bh // 8, 1)) | ((xs % bw) < max(bw // 8, 1))
    tint = rng.uniform(0.8, 1.15, (rows + 1, size // bw + 2, 1))
    base = np.clip(np.asarray(brick, np.float32)
                   * tint[row.reshape(-1), col.reshape(-1)].reshape(size, size, 1),
                   0, 255).astype(np.uint8)
    img = np.where(in_mortar[..., None], np.asarray(mortar, np.uint8), base)
    return np.concatenate([img, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def make_noise_texture(size: int = 128, base=(200, 60, 45), seed: int = 1) -> np.ndarray:
    """Smooth value-noise RGBA8 image (painted plaster)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0.6, 1.3, (size // 16 + 1, size // 16 + 1))
    y = (np.arange(size, dtype=np.float32) / 16.0)[:, None]
    x = (np.arange(size, dtype=np.float32) / 16.0)[None, :]
    x0, y0 = x.astype(int), y.astype(int)
    fx, fy = x - x0, y - y0
    v = (coarse[y0, x0] * (1 - fx) * (1 - fy)
         + coarse[y0, x0 + 1] * fx * (1 - fy)
         + coarse[y0 + 1, x0] * (1 - fx) * fy
         + coarse[y0 + 1, x0 + 1] * fx * fy)
    img = np.clip(np.asarray(base, np.float32) * v[..., None], 0, 255).astype(np.uint8)
    return np.concatenate([img, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def courtyard_source_images(seed: int = 0, texture_size: int = 128) -> list[np.ndarray]:
    """The textured courtyard's level-0 images in texture-index order: the
    floor map at `texture_size`, the two box maps at half of it (>= 128)."""
    half = max(texture_size // 2, 128)
    return [make_checker_texture(texture_size),     # 0: floor
            make_brick_texture(half, seed=seed),    # 1: stone boxes
            make_noise_texture(half, seed=seed)]    # 2: plaster boxes


CACHE_ENV = "GPU_RAYTRACER_TPU_TORCH_CACHE"
CACHE_MIN_TEXELS = 1024    # below this edge a build is quicker than the file's read


def cache_dir() -> str:
    """The texture cache's directory: $GPU_RAYTRACER_TPU_TORCH_CACHE, else
    ~/.cache/gpu_raytracer_tpu_torch. An empty value turns the cache off ("")."""
    return os.environ.get(CACHE_ENV, os.path.expanduser("~/.cache/gpu_raytracer_tpu_torch"))


@functools.lru_cache(maxsize=1)
def build_digest() -> str:
    """A digest of the source of the atlas build (this module's images and
    models/geometry.py's Textures.from_images), part of every cache key:
    a file written by another build of the code is never loaded."""
    from ..models import geometry

    h = hashlib.sha256()
    for path in (__file__, geometry.__file__):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def courtyard_textures(seed: int, texture_size: int, mips: int = 1,
                       budget_rows: int | None = None) -> Textures:
    """The courtyard's atlas on the CPU: `Textures.from_images` over
    `courtyard_source_images`. The build is deterministic in (seed, size,
    mips, budget) and the code (`build_digest`), so from CACHE_MIN_TEXELS
    texels up its tensors are kept in one .npz file per key in `cache_dir()`
    and loaded from there (bit-equal to a build). The cache is best-effort:
    a file that does not load is rebuilt and written again, through a
    temporary file and an atomic rename; a directory that cannot be written
    leaves it off."""
    build = lambda: Textures.from_images(courtyard_source_images(seed, texture_size),
                                         mips=mips, budget_rows=budget_rows)
    cdir = cache_dir()
    if not cdir or texture_size < CACHE_MIN_TEXELS:
        return build()
    key = f"ctex_{build_digest()}_s{seed}_t{texture_size}_m{mips}_b{budget_rows}"
    path = os.path.join(cdir, key + ".npz")
    fields = [f.name for f in dataclasses.fields(Textures) if f.name != "n_levels"]
    try:
        with np.load(path) as z:
            arrays = {k: torch.from_numpy(z[k]) for k in fields}
            n_levels = int(z["n_levels"])
        return Textures(**arrays, n_levels=n_levels)
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
        pass    # absent, unreadable or corrupt: build it and write it again
    tex = build()
    try:
        os.makedirs(cdir, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}.npz"
        np.savez(tmp, n_levels=np.int64(tex.n_levels),
                 **{k: getattr(tex, k).numpy() for k in fields})
        os.replace(tmp, path)
    except OSError:
        pass    # a read-only directory: the cache stays off
    return tex


def make_courtyard_scene(target_triangles: int = 100_000, seed: int = 0,
                         config: RaytracerConfig = DEFAULT_CONFIG,
                         lights: int = 2, textured: bool = False,
                         texture_size: int = 128, device="cpu") -> Scene:
    """Sponza-scale procedural stand-in: boxes on a constant-spacing grid
    (12 triangles each) and a rippled floor taking the rest of the budget.
    `textured=True` binds base-colour maps (floor at `texture_size` texels,
    boxes at half) with `config.texture_mips` mip levels, uvs projected
    from world space, (x + z, y) / 2."""
    rng = np.random.default_rng(seed)
    mats = MaterialBuilder()

    def base_map(index):
        ti = np.full(8, NO_TEXTURE, np.uint32)
        ti[TEX_BASE_COLOR] = index
        return ti

    if textured:
        m_stone = mats.add(albedo=(0.9, 0.85, 0.8), metallic=0.0, roughness=1.0,
                           texture_indices=base_map(1))
        m_floor = mats.add(albedo=(0.95, 0.95, 0.95), metallic=0.0, roughness=1.0,
                           texture_indices=base_map(0))
        m_metal = mats.add(albedo=(0.7, 0.6, 0.3), metallic=1.0, roughness=0.2)
        m_glass = mats.add_glass((0.4, 0.5, 0.8), 1.5, 0.9)
        m_red = mats.add(albedo=(1.0, 1.0, 1.0), metallic=0.0, roughness=1.0,
                         texture_indices=base_map(2))
    else:
        m_stone = mats.add_diffuse((0.6, 0.55, 0.5))
        m_floor = mats.add_diffuse((0.45, 0.42, 0.4))
        m_metal = mats.add_metallic((0.7, 0.6, 0.3), 0.2)
        m_glass = mats.add_glass((0.4, 0.5, 0.8), 1.5, 0.9)
        m_red = mats.add_diffuse((0.7, 0.15, 0.1))

    all_verts, all_faces, all_mats = [], [], []
    voffset = 0

    def add(verts, faces, mat_ids):
        nonlocal voffset
        all_verts.append(verts)
        all_faces.append(faces + voffset)
        all_mats.append(mat_ids)
        voffset += verts.shape[0]

    # constant spacing: the extent grows with the budget so there are
    # always sight lines between the boxes
    n_boxes = max(target_triangles // 24, 1)
    grid = int(np.ceil(np.sqrt(n_boxes)))
    spacing = 1.75
    extent = grid * spacing / 2.0
    # centres at half-spacing offsets: the lines x = k*spacing stay clear
    gx, gz = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    pos = np.stack([
        (gx.reshape(-1) - grid // 2 + 0.5) * spacing,
        np.zeros(grid * grid),
        (gz.reshape(-1) - grid // 2 + 0.5) * spacing,
    ], axis=1)[:n_boxes].astype(np.float32)
    heights = rng.uniform(0.5, 4.0, n_boxes).astype(np.float32)
    widths = rng.uniform(0.3, 1.2, (n_boxes, 2)).astype(np.float32)
    sizes = np.stack([widths[:, 0], heights, widths[:, 1]], axis=1)
    centers = pos + np.stack([np.zeros(n_boxes), heights / 2 + 0.2,
                              np.zeros(n_boxes)], axis=1)
    bv, bf = _boxes(centers, sizes)
    box_mats = rng.choice(np.asarray([m_stone, m_stone, m_stone, m_metal,
                                      m_glass, m_red], np.uint32), size=n_boxes)
    add(bv, bf, np.repeat(box_mats, 12))

    hf_tris = max(target_triangles - n_boxes * 12, 2)
    n = int(np.sqrt(hf_tris / 2)) + 1
    hv, hfc = _heightfield(n, n, -extent, extent, -extent, extent,
                           lambda x, z: 0.15 * np.sin(x * 0.8) * np.cos(z * 0.7))
    add(hv, hfc, np.full(hfc.shape[0], m_floor, np.uint32))

    verts = np.concatenate(all_verts)
    uv = None
    if textured:
        uv = np.stack([(verts[:, 0] + verts[:, 2]) * 0.5,
                       verts[:, 1] * 0.5], axis=1).astype(np.float32)
    mesh = Mesh.from_arrays(verts, np.concatenate(all_faces), np.concatenate(all_mats),
                            uv=uv)

    lb = LightBuilder()
    lb.add_directional((0.3, -1.0, 0.2), (1.0, 0.98, 0.9), 1.5)
    if lights > 1:
        lb.add_point((0.0, 8.0, 0.0), (1.0, 0.9, 0.7), 4.0)
    for _ in range(max(lights - 2, 0)):
        p = rng.uniform(-20, 20, 3)
        p[1] = rng.uniform(2, 6)
        lb.add_point(tuple(p), tuple(rng.uniform(0.5, 1.0, 3)), 2.0)

    # camera on the clear x = 0 lane, just inside the field, looking down it
    cam_z = float(np.floor(extent * 0.9 / spacing) * spacing)
    camera = Camera.create(position=(0.0, 2.5, cam_z),
                           direction=(0.0, -0.12, -1.0), fov=55.0)
    textures = None
    if textured:
        textures = courtyard_textures(
            seed, texture_size, mips=config.texture_mips,
            budget_rows=JAX_ATLAS_BUDGET_ROWS if config.texture_mips > 1 else None)
    return prepare_scene(camera, Spheres.from_rows([]), mesh, mats.build(),
                         lb.build(), textures=textures, config=config, device=device)


def zoo_source_images(n_texs: int = 24, seed: int = 0, size: int = 128) -> list[np.ndarray]:
    """n_texs distinct RGBA8 images, checker / brick / noise in rotation with
    a palette per index and mixed sizes (every third one half the edge): the
    zoo's level-0 images in texture-index order."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_texs):
        c0 = tuple(int(v) for v in rng.integers(120, 255, 3))
        c1 = tuple(int(v) for v in rng.integers(20, 120, 3))
        s = size if i % 3 else size // 2
        kind = i % 3
        if kind == 0:
            out.append(make_checker_texture(s, tiles=4 + i % 8, c0=c0, c1=c1))
        elif kind == 1:
            out.append(make_brick_texture(s, rows=4 + i % 6, brick=c0, mortar=c1,
                                          seed=seed + i))
        else:
            out.append(make_noise_texture(s, base=c0, seed=seed + i))
    return out


ZOO_ATLAS_BUDGET_ROWS = min(JAX_ATLAS_BUDGET_ROWS, 2048)   # the JAX package's zoo budget


def make_zoo_scene(target_triangles: int = 60_000, n_mats: int = 48, n_texs: int = 24,
                   seed: int = 0, config: RaytracerConfig = DEFAULT_CONFIG,
                   multi_slot: bool = False, device="cpu") -> Scene:
    """Material- and texture-count scale scene: the courtyard's box grid
    under `n_mats` materials cycling six kinds (textured diffuse, metallic-
    roughness, spec-gloss with a diffuse map, glass, occluded, emissive) over
    `n_texs` textures. Every textured kind binds a base-colour map;
    `multi_slot=True` also binds the metallic-roughness, occlusion and
    emissive maps of kinds 1, 4 and 5. The atlas keeps the JAX package's zoo
    budget (2048 rows), which drops the finest levels of the largest chains."""
    rng = np.random.default_rng(seed)
    mats = MaterialBuilder()

    def slots(**kw):
        ti = np.full(8, NO_TEXTURE, np.uint32)
        for k, v in kw.items():
            ti[{"base": TEX_BASE_COLOR, "mr": TEX_METALLIC_ROUGHNESS,
                "occ": TEX_OCCLUSION, "emi": TEX_EMISSIVE}[k]] = v
        return ti

    for i in range(n_mats):
        t0 = i % n_texs
        t1 = (i * 7 + 3) % n_texs
        alb = tuple(rng.uniform(0.4, 1.0, 3))
        kind = i % 6
        if kind == 0:       # textured diffuse
            mats.add(albedo=alb, roughness=1.0, texture_indices=slots(base=t0))
        elif kind == 1:     # textured metallic-roughness workflow
            mats.add(albedo=alb, metallic=0.9, roughness=0.3,
                     texture_indices=(slots(base=t0, mr=t1) if multi_slot
                                      else slots(base=t0)))
        elif kind == 2:     # spec-gloss workflow with a diffuse map
            mats.add(albedo=alb, metallic=0.0, roughness=0.6, material_type=1,
                     diffuse_factor=alb, specular_color=tuple(rng.uniform(0.2, 1.0, 3)),
                     glossiness_factor=float(rng.uniform(0.2, 0.9)),
                     texture_indices=slots(base=t0))
        elif kind == 3:     # glass, untextured
            mats.add_glass(alb, 1.5, 0.9)
        elif kind == 4:     # textured, with an ambient-occlusion map
            mats.add(albedo=alb, roughness=0.8,
                     texture_indices=(slots(base=t0, occ=t1) if multi_slot
                                      else slots(base=t0)))
        else:               # emissive map
            mats.add(albedo=alb, emission=tuple(rng.uniform(0, 0.5, 3)),
                     texture_indices=(slots(base=t0, emi=t1) if multi_slot
                                      else slots(base=t0)))

    n_boxes = max(target_triangles // 24, n_mats)
    grid = int(np.ceil(np.sqrt(n_boxes)))
    spacing = 1.75
    extent = grid * spacing / 2.0
    gx, gz = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    pos = np.stack([
        (gx.reshape(-1) - grid // 2 + 0.5) * spacing,
        np.zeros(grid * grid),
        (gz.reshape(-1) - grid // 2 + 0.5) * spacing,
    ], axis=1)[:n_boxes].astype(np.float32)
    heights = rng.uniform(0.5, 4.0, n_boxes).astype(np.float32)
    widths = rng.uniform(0.3, 1.2, (n_boxes, 2)).astype(np.float32)
    sizes = np.stack([widths[:, 0], heights, widths[:, 1]], axis=1)
    centers = pos + np.stack([np.zeros(n_boxes), heights / 2 + 0.2,
                              np.zeros(n_boxes)], axis=1)
    bv, bf = _boxes(centers, sizes)
    box_mats = (np.arange(n_boxes) % n_mats).astype(np.uint32)
    hf_tris = max(target_triangles - n_boxes * 12, 2)
    n = int(np.sqrt(hf_tris / 2)) + 1
    hv, hfc = _heightfield(n, n, -extent, extent, -extent, extent,
                           lambda x, z: 0.15 * np.sin(x * 0.8) * np.cos(z * 0.7))
    verts = np.concatenate([bv, hv])
    faces = np.concatenate([bf, hfc + bv.shape[0]])
    tri_mats = np.concatenate([np.repeat(box_mats, 12), np.full(hfc.shape[0], 0, np.uint32)])
    uv = np.stack([(verts[:, 0] + verts[:, 2]) * 0.5, verts[:, 1] * 0.5],
                  axis=1).astype(np.float32)
    mesh = Mesh.from_arrays(verts, faces, tri_mats, uv=uv)

    lb = LightBuilder()
    lb.add_directional((0.3, -1.0, 0.2), (1.0, 0.98, 0.9), 1.5)
    lb.add_point((0.0, 8.0, 0.0), (1.0, 0.9, 0.7), 4.0)
    cam_z = float(np.floor(extent * 0.9 / spacing) * spacing)
    camera = Camera.create(position=(0.0, 2.5, cam_z), direction=(0.0, -0.12, -1.0), fov=55.0)
    textures = Textures.from_images(
        zoo_source_images(n_texs, seed), mips=config.texture_mips,
        budget_rows=ZOO_ATLAS_BUDGET_ROWS if config.texture_mips > 1 else None)
    return prepare_scene(camera, Spheres.from_rows([]), mesh, mats.build(), lb.build(),
                         textures=textures, config=config, device=device)
