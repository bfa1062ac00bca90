"""The benchmark's inputs, made from the seed: the procedural courtyard.

A frozen copy of the courtyard generator of
`gpu_raytracer_tpu_torch/utils/procgen.py` (`make_courtyard_scene` up to its
`prepare_scene` call, and `courtyard_source_images`), so that a change to the
program's generator cannot change what the benchmark measures. It returns
plain NumPy arrays and parameter rows; `drivers/common.py` hands them to the
program's builders and `reference.py` reads them as they are.

The scene's seed is the configuration's (`scene_seed`, the program's default
0): the geometry is the deployment and stays the same in every run, as a
model's widths do. The run's `--seed` draws the camera inputs and the
sampled checks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

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

NO_TEXTURE = 0xFFFFFFFF


@dataclass
class MaterialRow:
    """One material as the program's `MaterialBuilder.add` takes it."""
    albedo: tuple
    metallic: float = 0.0
    roughness: float = 1.0
    ior: float = 1.5
    transmission: float = 0.0
    base_map: int = -1          # texture index of the base-colour map, -1 none


@dataclass
class LightRow:
    kind: str                   # "directional" or "point"
    vector: tuple               # direction (directional) or position (point)
    color: tuple
    intensity: float


@dataclass
class CourtyardInputs:
    vertices: np.ndarray        # [V,3] f32
    faces: np.ndarray           # [T,3] u32
    material_id: np.ndarray     # [T] u32
    uv: np.ndarray | None       # [V,2] f32 (textured)
    materials: list[MaterialRow]
    lights: list[LightRow]
    camera_position: tuple
    camera_direction: tuple
    fov: float
    extent: float               # half the courtyard's edge
    images: list[np.ndarray] = field(default_factory=list)   # RGBA8 level-0 maps


def _boxes(centers, sizes):
    verts = (_BOX_CORNERS[None] - 0.5) * sizes[:, None, :] + centers[:, None, :]
    faces = _BOX_FACES[None] + (np.arange(centers.shape[0], dtype=np.uint32) * 8)[:, None, None]
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


def checker_image(size: int, tiles: int = 8, c0=(230, 228, 220), c1=(60, 58, 54)):
    ax = ((np.arange(size, dtype=np.int32) * tiles // size) & 1).astype(np.uint8)
    cell = ax[:, None] ^ ax[None, :]
    palette = np.asarray([(*c0, 255), (*c1, 255)], np.uint8)
    return palette[cell]


def brick_image(size: int, rows: int = 8, brick=(180, 96, 70), mortar=(200, 196, 188),
                seed: int = 0):
    rng = np.random.default_rng(seed)
    y = np.arange(size)[:, None]
    x = np.arange(size)[None, :]
    bh = size // rows
    bw = bh * 2
    row = y // bh
    xs = x + (row % 2) * (bw // 2)
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


def noise_image(size: int, base=(200, 60, 45), seed: int = 1):
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


def courtyard_images(seed: int, texture_size: int) -> list[np.ndarray]:
    """The textured courtyard's level-0 maps in texture-index order: the
    floor at `texture_size` texels, the two box maps at half of it (>= 128)."""
    half = max(texture_size // 2, 128)
    return [checker_image(texture_size), brick_image(half, seed=seed),
            noise_image(half, seed=seed)]


def courtyard(target_triangles: int, seed: int = 0, lights: int = 2, textured: bool = False,
              texture_size: int = 128) -> CourtyardInputs:
    """Boxes on a constant-spacing grid (12 triangles each) and a rippled
    floor taking the rest of the budget, the camera on the clear x = 0 lane
    looking down it."""
    rng = np.random.default_rng(seed)
    if textured:
        mats = [MaterialRow((0.9, 0.85, 0.8), base_map=1),              # stone
                MaterialRow((0.95, 0.95, 0.95), base_map=0),            # floor
                MaterialRow((0.7, 0.6, 0.3), metallic=1.0, roughness=0.2),
                MaterialRow((0.4, 0.5, 0.8), roughness=0.0, ior=1.5, transmission=0.9),
                MaterialRow((1.0, 1.0, 1.0), base_map=2)]               # plaster
    else:
        mats = [MaterialRow((0.6, 0.55, 0.5)), MaterialRow((0.45, 0.42, 0.4)),
                MaterialRow((0.7, 0.6, 0.3), metallic=1.0, roughness=0.2),
                MaterialRow((0.4, 0.5, 0.8), roughness=0.0, ior=1.5, transmission=0.9),
                MaterialRow((0.7, 0.15, 0.1))]
    m_stone, m_floor, m_metal, m_glass, m_red = range(5)

    n_boxes = max(target_triangles // 24, 1)
    grid = int(np.ceil(np.sqrt(n_boxes)))
    spacing = 1.75
    extent = grid * spacing / 2.0
    gx, gz = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    pos = np.stack([(gx.reshape(-1) - grid // 2 + 0.5) * spacing, np.zeros(grid * grid),
                    (gz.reshape(-1) - grid // 2 + 0.5) * spacing],
                   axis=1)[:n_boxes].astype(np.float32)
    heights = rng.uniform(0.5, 4.0, n_boxes).astype(np.float32)
    widths = rng.uniform(0.3, 1.2, (n_boxes, 2)).astype(np.float32)
    sizes = np.stack([widths[:, 0], heights, widths[:, 1]], axis=1)
    centers = pos + np.stack([np.zeros(n_boxes), heights / 2 + 0.2, np.zeros(n_boxes)], axis=1)
    bv, bf = _boxes(centers, sizes)
    box_mats = rng.choice(np.asarray([m_stone, m_stone, m_stone, m_metal, m_glass, m_red],
                                     np.uint32), size=n_boxes)

    hf_tris = max(target_triangles - n_boxes * 12, 2)
    n = int(np.sqrt(hf_tris / 2)) + 1
    hv, hf = _heightfield(n, n, -extent, extent, -extent, extent,
                          lambda x, z: 0.15 * np.sin(x * 0.8) * np.cos(z * 0.7))

    verts = np.concatenate([bv, hv])
    faces = np.concatenate([bf, hf + np.uint32(bv.shape[0])])
    mat_id = np.concatenate([np.repeat(box_mats, 12),
                             np.full(hf.shape[0], m_floor, np.uint32)]).astype(np.uint32)
    uv = None
    if textured:
        uv = np.stack([(verts[:, 0] + verts[:, 2]) * 0.5, verts[:, 1] * 0.5],
                      axis=1).astype(np.float32)

    light_rows = [LightRow("directional", (0.3, -1.0, 0.2), (1.0, 0.98, 0.9), 1.5)]
    if lights > 1:
        light_rows.append(LightRow("point", (0.0, 8.0, 0.0), (1.0, 0.9, 0.7), 4.0))
    for _ in range(max(lights - 2, 0)):
        p = rng.uniform(-20, 20, 3)
        p[1] = rng.uniform(2, 6)
        light_rows.append(LightRow("point", tuple(p), tuple(rng.uniform(0.5, 1.0, 3)), 2.0))

    cam_z = float(np.floor(extent * 0.9 / spacing) * spacing)
    images = courtyard_images(seed, texture_size) if textured else []
    return CourtyardInputs(verts.astype(np.float32), faces, mat_id, uv, mats, light_rows,
                           (0.0, 2.5, cam_z), (0.0, -0.12, -1.0), 55.0, float(extent), images)
