"""Geometric primitives (struct-of-arrays) + host helpers."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Spheres:
    center: torch.Tensor       # [S,3] f32
    radius: torch.Tensor       # [S] f32
    material_id: torch.Tensor  # [S] u32 value
    # every sphere is a radius-0 guard that can never hit
    all_guards: bool = False

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def from_rows(rows: list[tuple]) -> "Spheres":
        """rows: (center, radius, material_id). An empty list gets one
        radius-0 sphere: a guaranteed miss (discriminant < 0 unless the ray
        passes exactly through the centre, and then t <= MIN_RAY_DISTANCE)."""
        if not rows:
            rows = [((0.0, 0.0, 0.0), 0.0, 0)]
        c = np.asarray([r[0] for r in rows], np.float32).reshape(-1, 3)
        rad = np.asarray([r[1] for r in rows], np.float32)
        mid = np.asarray([r[2] for r in rows], np.uint32).astype(np.int64)
        return Spheres(torch.from_numpy(c), torch.from_numpy(rad),
                       torch.from_numpy(mid), all_guards=bool((rad == 0.0).all()))


@dataclass
class Mesh:
    """Indexed triangle mesh. `from_arrays` keeps NumPy arrays: the mesh is
    a host-side asset for the BVH build; `prepare_scene` turns it into
    tensors once."""

    vertices: np.ndarray | torch.Tensor     # [V,3] f32
    indices: np.ndarray | torch.Tensor      # [T,3] u32 (int64 as tensor)
    material_id: np.ndarray | torch.Tensor  # [T] u32 (int64 as tensor)
    uv: np.ndarray | torch.Tensor           # [V,2] f32

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @staticmethod
    def empty() -> "Mesh":
        # one degenerate triangle at the origin: Möller-Trumbore's
        # |det| < MIN_RAY_DISTANCE guard rejects it, so it never hits
        return Mesh(vertices=np.zeros((1, 3), np.float32),
                    indices=np.zeros((1, 3), np.uint32),
                    material_id=np.zeros((1,), np.uint32),
                    uv=np.zeros((1, 2), np.float32))

    @staticmethod
    def from_arrays(vertices, indices, material_id, uv=None) -> "Mesh":
        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        i = np.asarray(indices, np.uint32).reshape(-1, 3)
        m = np.asarray(material_id, np.uint32).reshape(-1)
        if i.shape[0] != m.shape[0]:
            raise ValueError(f"{i.shape[0]} triangles but {m.shape[0]} material ids")
        if i.shape[0] == 0:
            return Mesh.empty()
        t = (np.zeros((v.shape[0], 2), np.float32) if uv is None
             else np.asarray(uv, np.float32).reshape(-1, 2))
        if t.shape[0] != v.shape[0]:
            raise ValueError(f"{v.shape[0]} vertices but {t.shape[0]} uvs")
        return Mesh(v, i, m, t)

    def to_tensors(self) -> "Mesh":
        return Mesh(torch.from_numpy(np.ascontiguousarray(self.vertices)),
                    torch.from_numpy(np.asarray(self.indices).astype(np.int64)),
                    torch.from_numpy(np.asarray(self.material_id).astype(np.int64)),
                    torch.from_numpy(np.ascontiguousarray(self.uv)))


def dedup_triangles(tri_vertices: np.ndarray, material_ids: np.ndarray):
    """Fat triangles [T,3,3] -> indexed mesh with bit-exact position dedup,
    vertices in first-appearance order."""
    tri_vertices = np.asarray(tri_vertices, np.float32).reshape(-1, 3, 3)
    flat = tri_vertices.reshape(-1, 3)
    _, first_idx, inverse = np.unique(flat.view(np.uint32), axis=0,
                                      return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    vertices = flat[np.sort(first_idx)]
    indices = rank[inverse].reshape(-1, 3).astype(np.uint32)
    return vertices, indices, np.asarray(material_ids, np.uint32)


def triangle_aabbs(vertices: np.ndarray, indices: np.ndarray):
    """Per-triangle AABBs -> (min [T,3], max [T,3])."""
    tri = vertices[indices]
    return tri.min(axis=1), tri.max(axis=1)


# Payload texels per 128-texel atlas row: lane 127 of each row is a guard
# texel repeating the wrap neighbour of lane 126's texel (see Textures).
TEX_CHUNK = 127

# The JAX package's atlas budget (its texture kernel keeps the atlas resident
# in 4096 rows of TPU on-chip memory): `make_courtyard_scene` passes it to
# `Textures.from_images` so both packages build the same atlas. Kept for that
# parity only; the CUDA kernels read the atlas from device memory and set no
# limit on its size.
JAX_ATLAS_BUDGET_ROWS = 4096


def _wrap_coords(x: np.ndarray, size: int, mode: int) -> np.ndarray:
    """Sampler wrap of integer texel coordinates to [0, size):
    0 = REPEAT, 1 = CLAMP_TO_EDGE, 2 = MIRRORED_REPEAT."""
    if mode == 1:
        return np.clip(x, 0, size - 1)
    if mode == 2:
        per = np.mod(x, 2 * size)
        return np.where(per < size, per, 2 * size - 1 - per)
    return np.mod(x, size)


def _downsample2x(img: np.ndarray) -> np.ndarray:
    """2x2 box-filter mip reduction of [H,W,4] u8, edge-clamped, rounding
    half up."""
    h, w = img.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    y0 = np.minimum(np.arange(h2) * 2, h - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x0 = np.minimum(np.arange(w2) * 2, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    acc = (img[y0][:, x0].astype(np.uint16) + img[y0][:, x1]
           + img[y1][:, x0] + img[y1][:, x1])
    return ((acc + 2) // 4).astype(np.uint8)


def _atlas_block(img: np.ndarray, mode: int) -> np.ndarray:
    """Guard-band atlas block of one RGBA8 image -> [h+1, srows, 128] u32.
    Lane l of chunk k of texture row y holds texel (wrap_x(127k + l),
    wrap_y(y)): the guard lanes, the tail padding and the extra guard row
    all come from the same formula."""
    h, w = img.shape[:2]
    srows = -(-w // TEX_CHUNK)
    xs = _wrap_coords(np.arange(srows)[:, None] * TEX_CHUNK + np.arange(128), w, mode)
    ys = _wrap_coords(np.arange(h + 1), h, mode)
    texels = np.ascontiguousarray(img).reshape(h, w, 4).view("<u4")[:, :, 0]
    return texels[ys[:, None, None], xs[None, :, :]]


def _level_rows(img: np.ndarray) -> int:
    h, w = img.shape[:2]
    return (h + 1) * (-(-w // TEX_CHUNK))


@dataclass
class Textures:
    """Texture atlas: the JAX package's guard-band layout, field for field.

    The atlas is a stack of 128-texel rows. Each texture row is split into
    `srows` chunks of 127 texels; lane 127 of a chunk repeats the wrap
    neighbour of the next texel column, and one extra row per texture (and
    per mip level) repeats the vertical wrap row. Texel (x, y) lies at
    address (offset_row + y*srows + x//127)*128 + x%127, and the four
    bilinear taps are always a, a+1, a + srows*128 and a + srows*128 + 1.
    Texels are little-endian RGBA8 packed into one unsigned 32-bit value.
    Mip level l+1 of a texture follows level l, laid out as a texture of its
    own size (w_{l+1} = max(w_l//2, 1), likewise h), so every level's
    address derives from level 0's metadata. Unsigned 32-bit columns are
    int64 tensors holding the unsigned value."""

    width: torch.Tensor       # [N] level-0 texel width
    height: torch.Tensor      # [N] level-0 texel height
    format: torch.Tensor      # [N] 3 = RGBA8
    offset: torch.Tensor      # [N] byte offset of the texture's first atlas row
    size: torch.Tensor        # [N] atlas bytes of all its levels
    wrap: torch.Tensor        # [N] 0 REPEAT, 1 CLAMP_TO_EDGE, 2 MIRRORED_REPEAT
    data_u32: torch.Tensor    # [R*128] texels, R whole atlas rows
    srows: torch.Tensor       # [N] atlas rows per texture row, ceil(w/127)
    offset_row: torch.Tensor  # [N] atlas row of texel (0, 0)
    levels: torch.Tensor      # [N] mip chain length
    n_levels: int = 1         # longest chain (1 = no mips)

    @property
    def textured(self) -> bool:
        return self.data_u32.numel() > 1

    @property
    def count(self) -> int:
        return self.width.shape[0]

    @property
    def num_rows(self) -> int:
        return self.data_u32.shape[0] // 128

    @staticmethod
    def empty() -> "Textures":
        z = lambda: torch.zeros((1,), dtype=torch.int64)
        return Textures(z(), z(), z(), z(), z(), z(), z(), z(), z(),
                        levels=torch.ones((1,), dtype=torch.int64))

    @staticmethod
    def from_images(images: list[np.ndarray], wrap: list[int] | None = None,
                    mips: int = 1, budget_rows: int | None = None) -> "Textures":
        """images: [H,W,4] uint8 arrays; wrap: per-texture wrap modes
        (REPEAT by default); mips: most mip levels to build (1 = none);
        budget_rows: if set, drop the finest level of the single most
        row-expensive chain until the atlas fits that many rows."""
        if not images:
            return Textures.empty()
        wrap = list(wrap) if wrap is not None else [0] * len(images)
        chains = []
        for img in images:
            img = np.ascontiguousarray(np.asarray(img, np.uint8))
            if img.ndim != 3 or img.shape[2] != 4:
                raise ValueError(f"textures must be RGBA8 [H,W,4], got {img.shape}")
            chain = [img]
            while len(chain) < mips and max(chain[-1].shape[:2]) > 1:
                chain.append(_downsample2x(chain[-1]))
            chains.append(chain)
        if budget_rows is not None:
            while sum(_level_rows(lv) for c in chains for lv in c) > budget_rows:
                droppable = [i for i, c in enumerate(chains) if len(c) > 1]
                if not droppable:
                    break
                worst = max(droppable, key=lambda i: _level_rows(chains[i][0]))
                chains[worst] = chains[worst][1:]

        meta = {k: [] for k in ("width", "height", "offset", "size", "srows",
                                "offset_row", "levels")}
        blocks, row = [], 0
        for chain, mode in zip(chains, wrap):
            h, w = chain[0].shape[:2]
            tex_rows = sum(_level_rows(lv) for lv in chain)
            for k, v in (("width", w), ("height", h), ("offset", row * 512),
                         ("size", tex_rows * 512), ("srows", -(-w // TEX_CHUNK)),
                         ("offset_row", row), ("levels", len(chain))):
                meta[k].append(v)
            blocks += [_atlas_block(lv, mode).reshape(-1) for lv in chain]
            row += tex_rows
        t = lambda x: torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))
        return Textures(**{k: t(v) for k, v in meta.items()},
                        format=t([3] * len(images)), wrap=t(wrap),
                        data_u32=t(np.concatenate(blocks)),
                        n_levels=max(len(c) for c in chains))
