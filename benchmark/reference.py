"""The plain reference: what the program's frames, images and presented
pixels should be, worked out again from the benchmark's own inputs.

Plain PyTorch and NumPy, on any device, in the precision it is given
(`dtype`: float32, or bfloat16 for the lower-precision control). It imports
nothing of the program and takes nothing the program made: its camera comes
from replaying the window's inputs through its own controller, its hits from
its own tree (bvh.py), its materials and lights from the configuration's rows.

Semantics, as the program states them (README, ops/shading.py,
ops/wavefront.py, ops/sampling.py, models/camera.py of the port):
  * camera: yaw about +Y on x, z; pitch added to y, clamped to +-0.99, then
    renormalised; moves along direction and right = direction x up; rays
    through pixel centres (or jittered), aspect x tan(fov / 2);
  * Whitted frame: ambient 0.1 albedo, per light N.L x intensity, a point
    light's attenuation 1 / (1 + 0.01 d^2) rounded to f16, shadow rays from
    1e-3 off the surface, BRDF 0.5 for metals and 1 / pi otherwise, the glass
    blend with dispersion (-0.018, 0, 0.035) toward (0.2, 0.2, 0.3), black sky;
    material scalars stored as f16;
  * path tracer: per bounce the sky (0.1, 0.2, 0.3) x throughput on a miss,
    on a hit one light picked uniformly with its shadow ray, weighted by the
    light count; cosine, fuzzed mirror or Fresnel glass continuations (a full
    RGB ray collapses to one wavelength at glass, throughput x3 one-hot);
    Russian roulette on continuations entering depth >= 2, p = clamp(max
    throughput, 0.05, 0.95); depths 0-4, the last one not continued;
  * fly frame: the G-buffer of the primary hits at pixel centres, and the
    à-trous filter as ops/denoise.py's header states it (`atrous`).
Its random numbers are its own (a torch.Generator), so a path-traced image is
compared by its statistics (checks.py), not pixel for pixel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import bvh

SKY_PATH = (0.1, 0.2, 0.3)
DISPERSION = (-0.018, 0.0, 0.035)
TRANSMITTED = (0.2, 0.2, 0.3)
SRGB_CUT = 0.0031308


# ---- camera ----

@dataclass
class CameraState:
    position: np.ndarray      # [3] f32
    direction: np.ndarray     # [3] f32 unit
    up: np.ndarray            # [3] f32
    fov: float


def start_camera(position, direction, fov) -> CameraState:
    d = np.asarray(direction, np.float64)
    d = (d / np.linalg.norm(d)).astype(np.float32)
    return CameraState(np.asarray(position, np.float32), d,
                       np.asarray((0.0, 1.0, 0.0), np.float32), float(fov))


class Controller:
    """WASD moves and mouse-drag looks, in float32."""

    def __init__(self, cam: CameraState, move_speed=0.1, sensitivity=0.005, clamp=0.99):
        self.pos = cam.position.copy()
        self.dir = cam.direction.copy()
        self.up = cam.up.copy()
        self.fov = cam.fov
        self.speed, self.sens, self.clamp = move_speed, sensitivity, clamp

    def apply(self, event) -> None:
        if event[0] == "drag":
            self.rotate(event[1], event[2])
        else:
            fwd, strafe = {"w": (1.0, 0.0), "s": (-1.0, 0.0), "a": (0.0, -1.0),
                           "d": (0.0, 1.0)}[event[1]]
            self.move(fwd, strafe)

    def rotate(self, dx, dy) -> None:
        yaw, pitch = -dx * self.sens, -dy * self.sens
        c, s = math.cos(yaw), math.sin(yaw)
        x, y, z = self.dir
        d = np.asarray([x * c - z * s, y, x * s + z * c], np.float32)
        d[1] = float(np.clip(d[1] + pitch, -self.clamp, self.clamp))
        self.dir = d / np.linalg.norm(d)

    def move(self, forward, strafe) -> None:
        right = np.cross(self.dir, self.up)
        n = np.linalg.norm(right)
        if n > 0:
            right = right / n
        self.pos = (self.pos + self.dir * (forward * self.speed)
                    + right * (strafe * self.speed)).astype(np.float32)

    def state(self) -> CameraState:
        return CameraState(self.pos.copy(), self.dir.copy(), self.up.copy(), self.fov)


def camera_rays(cam: CameraState, width, height, px, py, jitter=None, dtype=torch.float32):
    """Rays through pixels px, py [N] (centres, or `jitter` [N,2] in [0, 1))."""
    dev = px.device
    w = torch.full((), width, dtype=dtype, device=dev)
    h = torch.full((), height, dtype=dtype, device=dev)
    jx = 0.5 if jitter is None else jitter[:, 0].to(dtype)
    jy = 0.5 if jitter is None else jitter[:, 1].to(dtype)
    u = (px.to(dtype) + jx) / w
    v = (py.to(dtype) + jy) / h
    fs = float(np.tan(np.float32(cam.fov) * np.float32(0.5 * math.pi / 180.0)))
    cx = (u * 2.0 - 1.0) * (w / h) * fs
    cy = (1.0 - v * 2.0) * fs
    fwd = torch.as_tensor(cam.direction, device=dev).to(dtype)
    up = torch.as_tensor(cam.up, device=dev).to(dtype)
    right = bvh._cross(fwd, up)
    true_up = bvh._cross(right, fwd)
    d = fwd + right * cx[:, None] + true_up * cy[:, None]
    d = d / torch.sqrt(bvh._dot(d, d))[:, None]
    o = torch.as_tensor(cam.position, device=dev).to(dtype).expand_as(d)
    return o, d


# ---- the scene as the reference holds it ----

@dataclass
class RefScene:
    tree: bvh.Tree
    normal: torch.Tensor       # [T,3] unit geometric normal per original triangle
    tri_mat: torch.Tensor      # [T] i64
    albedo: torch.Tensor       # [M,3]
    metallic: torch.Tensor     # [M] (f16 values)
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    light_kind: list           # "directional" / "point"
    light_vec: torch.Tensor    # [L,3] unit direction or position
    light_color: torch.Tensor  # [L,3]
    light_intensity: torch.Tensor   # [L]
    dtype: torch.dtype
    base_map: torch.Tensor | None = None   # [M] i64 texture index, -1 none
    corner_uv: torch.Tensor | None = None  # [T,3,2] per-triangle corner uvs
    corners: torch.Tensor | None = None    # [T,3,3] per-triangle corner positions
    density: torch.Tensor | None = None    # [T] mip uv density, 14-bit rounded
    maps: list | None = None               # per texture: its mip levels, [h,w,4] u8 tensors

    @property
    def device(self):
        return self.albedo.device


def _f16(x) -> np.ndarray:
    return np.asarray(np.asarray(x, np.float32).astype(np.float16), np.float32)


def ref_scene(inputs, device, dtype=torch.float32, mips: int = 1,
              budget_rows: int | None = None, width: int = 4, leaf: int = 8) -> RefScene:
    """The reference's tables from the configuration's inputs (scenes.py):
    its own tree of `width` and `leaf` (bvh.py), a textured scene's maps with
    `mips` levels within `budget_rows`."""
    tree = bvh.build(inputs.vertices, inputs.faces, width, leaf)
    v = np.asarray(inputs.vertices, np.float32)
    f = np.asarray(inputs.faces, np.int64)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    m = inputs.materials
    lights = inputs.lights
    lv = []
    for li in lights:
        x = np.asarray(li.vector, np.float64)
        lv.append(x / np.linalg.norm(x) if li.kind == "directional" else x)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
    textured = {}
    if inputs.images:
        cuv = np.asarray(inputs.uv, np.float32)[f]                    # [T,3,2]
        textured = dict(
            base_map=torch.as_tensor([r.base_map for r in m], device=device),
            corner_uv=t(cuv), corners=t(v[f]),
            density=torch.as_tensor(uv_density(v, f, cuv), device=device),
            maps=[[torch.as_tensor(level, device=device) for level in chain]
                  for chain in mip_chains(inputs.images, mips, budget_rows)])
    return RefScene(
        tree=tree.to(device, dtype), normal=t(n.astype(np.float32)),
        tri_mat=torch.as_tensor(np.asarray(inputs.material_id, np.int64), device=device),
        albedo=t([r.albedo for r in m]), metallic=t(_f16([r.metallic for r in m])),
        roughness=t(_f16([r.roughness for r in m])), ior=t(_f16([r.ior for r in m])),
        transmission=t(_f16([r.transmission for r in m])),
        light_kind=[li.kind for li in lights], light_vec=t(np.asarray(lv, np.float32)),
        light_color=t([li.color for li in lights]),
        light_intensity=t([li.intensity for li in lights]), dtype=dtype, **textured)


# ---- textures ----

TEX_CHUNK = 127        # texels of a 128-texel atlas row (one is a guard)
SQRT2 = float(np.float32(1.4142135))


def downsample(img: np.ndarray) -> np.ndarray:
    """2x2 box filter of RGBA8 [H,W,4], edges clamped, rounding half up."""
    h, w = img.shape[:2]
    y0 = np.minimum(np.arange(max(h // 2, 1)) * 2, h - 1)
    x0 = np.minimum(np.arange(max(w // 2, 1)) * 2, w - 1)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    acc = (img[y0][:, x0].astype(np.uint16) + img[y0][:, x1] + img[y1][:, x0]
           + img[y1][:, x1])
    return ((acc + 2) // 4).astype(np.uint8)


def _rows(img) -> int:
    """Atlas rows a level takes: h + 1 rows of ceil(w / 127) chunks."""
    h, w = img.shape[:2]
    return (h + 1) * -(-w // TEX_CHUNK)


def mip_chains(images, mips: int, budget_rows: int | None) -> list:
    """Each map's levels, at most `mips`; over `budget_rows` atlas rows, the
    finest level of the chain whose first level takes most rows goes, until
    the maps fit."""
    chains = []
    for img in images:
        chain = [np.ascontiguousarray(img)]
        while len(chain) < mips and max(chain[-1].shape[:2]) > 1:
            chain.append(downsample(chain[-1]))
        chains.append(chain)
    while budget_rows is not None and sum(_rows(lv) for c in chains for lv in c) > budget_rows:
        cut = [i for i, c in enumerate(chains) if len(c) > 1]
        if not cut:
            break
        worst = max(cut, key=lambda i: _rows(chains[i][0]))
        chains[worst] = chains[worst][1:]
    return chains


def uv_density(v, f, cuv) -> np.ndarray:
    """Texels per world unit at unit map size of each triangle,
    sqrt(|uv area| / |world area|), rounded to 8 exponent and 6 mantissa
    bits as the scene format stores it."""
    e1 = (v[f[:, 1]] - v[f[:, 0]]).astype(np.float32)
    e2 = (v[f[:, 2]] - v[f[:, 0]]).astype(np.float32)
    n2 = np.maximum((np.cross(e1, e2) ** 2).sum(axis=1), np.float32(1e-30))
    cr = ((cuv[:, 1, 0] - cuv[:, 0, 0]) * (cuv[:, 2, 1] - cuv[:, 0, 1])
          - (cuv[:, 2, 0] - cuv[:, 0, 0]) * (cuv[:, 1, 1] - cuv[:, 0, 1]))
    den = np.sqrt(np.abs(cr) / np.sqrt(n2)).astype(np.float32)
    code = np.clip((den.view(np.int32).astype(np.int64) + 0x10000) >> 17, 0, (254 << 6) | 63)
    return (code.astype(np.int32) << 17).view(np.float32)


def sample_base(rs: RefScene, tex, uv, lam):
    """Base-colour RGB [N,3] of maps `tex` [N] (-1 none: white) at uv [N,2]:
    bilinear, REPEAT, at the nearest mip level of footprint `lam`:
    floor(log2(lam * width * sqrt2)), clamped to the chain."""
    out = torch.ones((tex.shape[0], 3), dtype=rs.dtype, device=uv.device)
    for k, chain in enumerate(rs.maps):
        sel = torch.nonzero(tex == k)[:, 0]
        if sel.numel() == 0:
            continue
        w0 = chain[0].shape[1]
        foot = torch.clamp(lam[sel].float() * float(w0), min=1e-20) * SQRT2
        level = torch.clamp(torch.frexp(foot)[1] - 1, 0, len(chain) - 1)
        for lv, img in enumerate(chain):
            s = sel[level == lv]
            if s.numel() == 0:
                continue
            h, w = img.shape[:2]
            uf = uv[s, 0].float() * w - 0.5
            vf = uv[s, 1].float() * h - 0.5
            x0f, y0f = torch.floor(uf), torch.floor(vf)
            fx, fy = (uf - x0f)[:, None], (vf - y0f)[:, None]
            x0, y0 = torch.remainder(x0f.long(), w), torch.remainder(y0f.long(), h)
            x1, y1 = torch.remainder(x0 + 1, w), torch.remainder(y0 + 1, h)
            px = lambda y, x: img[y, x, :3].float()
            top = px(y0, x0) * (1.0 - fx) + px(y0, x1) * fx
            bot = px(y1, x0) * (1.0 - fx) + px(y1, x1) * fx
            out[s] = ((top * (1.0 - fy) + bot * fy) * (1.0 / 255.0)).to(rs.dtype)
    return out


@dataclass
class Hits:
    hit: torch.Tensor          # [N] bool
    t: torch.Tensor
    point: torch.Tensor        # [N,3]
    normal: torch.Tensor       # [N,3] (0 on a miss)
    mat: torch.Tensor          # [N] i64 (0 on a miss)
    slots: int                 # child boxes tested
    tests: int
    tri: torch.Tensor | None = None   # [N] i64 triangle, -1 on a miss


def trace(rs: RefScene, o, d, max_t=None) -> Hits:
    if max_t is None:
        max_t = torch.full((o.shape[0],), torch.finfo(o.dtype).max, dtype=o.dtype,
                           device=o.device)
    w = bvh.walk(rs.tree, o, d, max_t)
    hit = w.tri >= 0
    ti = torch.clamp(w.tri, min=0)
    t = torch.where(hit, w.t, torch.zeros_like(w.t))
    zero = torch.zeros_like(o)
    return Hits(hit, w.t, torch.where(hit[:, None], o + d * t[:, None], zero),
                torch.where(hit[:, None], rs.normal[ti], zero),
                torch.where(hit, rs.tri_mat[ti], torch.zeros_like(ti)), w.slots, w.tests, w.tri)


def hit_uv(rs: RefScene, o, d, h: Hits):
    """The hits' texture coordinates: the corner uvs weighted by the
    Möller-Trumbore barycentrics of the hit triangle."""
    ti = torch.clamp(h.tri, min=0)
    cuv = rs.corner_uv[ti]
    tri_v = rs.corners[ti]
    e1, e2 = tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0]
    hh = bvh._cross(d, e2)
    a = bvh._dot(e1, hh)
    f = 1.0 / torch.where(a == 0.0, torch.ones_like(a), a)
    s = o - tri_v[:, 0]
    bu = f * bvh._dot(s, hh)
    bv = f * bvh._dot(d, bvh._cross(s, e1))
    return cuv[:, 0] * (1.0 - bu - bv)[:, None] + cuv[:, 1] * bu[:, None] + cuv[:, 2] * bv[:, None]


@dataclass
class Work:
    """The walks' work of a batch of rays, for the rooflines."""
    rays: int = 0
    hits: int = 0
    texel_hits: int = 0
    shadow_rays: int = 0
    slots: int = 0
    tests: int = 0

    def scaled(self, s: float) -> dict:
        return {k: getattr(self, k) * s for k in self.__dataclass_fields__}


def _occluded(rs: RefScene, o, d, max_t, work: Work):
    live = max_t > 0
    w = bvh.walk(rs.tree, o, d, max_t, any_hit=True)
    work.shadow_rays += int(live.sum())
    work.slots += w.slots
    work.tests += w.tests
    return w.tri >= 0


def _light_terms(rs: RefScene, h: Hits, li: int):
    """Light `li` at the hits -> (unshadowed intensity [N], shadow ray
    origin, direction, max_t)."""
    inten = rs.light_intensity[li]
    if rs.light_kind[li] == "directional":
        ldir = rs.light_vec[li]
        ldir = ldir / torch.sqrt(bvh._dot(ldir, ldir))
        I = torch.clamp(bvh._dot(h.normal, -ldir[None, :]), min=0.0) * inten
        sdir = (-ldir)[None, :].expand_as(h.normal)
        smax = torch.full_like(I, 3.0e38)
    else:
        to_l = rs.light_vec[li][None, :] - h.point
        dist = torch.sqrt(bvh._dot(to_l, to_l))
        sdir = to_l / dist[:, None]
        atten = (1.0 / (1.0 + dist * dist * 0.01)).to(torch.float16).to(dist.dtype)
        I = torch.clamp(bvh._dot(h.normal, sdir), min=0.0) * inten * atten
        smax = dist - 1e-3
    I = torch.nan_to_num(I, nan=0.0)
    return I, h.point + h.normal * 1e-3, sdir, smax


def _brdf(rs: RefScene, mid):
    return torch.where(rs.metallic[mid] > 0.5, 0.5, 1.0 / math.pi).to(rs.dtype)


def _glass_blend(rs: RefScene, mid, color):
    ior = rs.ior[mid][:, None]
    trans = torch.clamp(rs.transmission[mid], 0.0, 1.0)[:, None]
    disp = torch.tensor(DISPERSION, dtype=rs.dtype, device=color.device)[None, :]
    base = torch.tensor(TRANSMITTED, dtype=rs.dtype, device=color.device)[None, :]
    transmitted = base * ((ior + disp - 1.0) / (ior - 1.0))
    return torch.where(trans > 0.0, color * (1.0 - trans) + transmitted * trans, color)


def pixel_scale(cam: CameraState, height: int) -> float:
    """A pixel's angular size, 2 tan(fov / 2) / height, in f32 steps."""
    f = np.float32
    fs = f(np.tan(f(cam.fov) * f(0.5 * math.pi / 180.0)))
    return float(f(2.0) * fs * f(1.0 / height))


def whitted(rs: RefScene, o, d, shadows: bool, work: Work | None = None, pix: float = 0.0):
    """The Viewer's frame at rays o, d: RGB [N,3] in float32. A textured
    scene's base-colour maps are sampled at the mip level of each hit's
    footprint, t x `pix` (pixel_scale) x the triangle's uv density."""
    work = Work() if work is None else work
    h = trace(rs, o, d)
    work.rays += o.shape[0]
    work.hits += int(h.hit.sum())
    work.slots += h.slots
    work.tests += h.tests
    mid = h.mat
    albedo = rs.albedo[mid]
    if rs.maps:
        ti = torch.clamp(h.tri, min=0)
        lam = h.t.float() * pix * rs.density[ti]
        tex = torch.where(h.hit, rs.base_map[mid], torch.full_like(mid, -1))
        work.texel_hits += int((tex >= 0).sum())
        albedo = albedo * sample_base(rs, tex, hit_uv(rs, o, d, h), torch.where(
            h.hit, lam, torch.zeros_like(lam)))
    light = torch.zeros_like(albedo)
    for li in range(len(rs.light_kind)):
        I, so, sd, smax = _light_terms(rs, h, li)
        if shadows:
            live = h.hit & (I > 0.0)
            blocked = _occluded(rs, so, sd, torch.where(live, smax, torch.zeros_like(smax)), work)
            I = I * (~blocked).to(I.dtype)
        light = light + I[:, None] * rs.light_color[li][None, :]
    color = _glass_blend(rs, mid, albedo * 0.1 + (albedo * _brdf(rs, mid)[:, None]) * light)
    return torch.where(h.hit[:, None], color, torch.zeros_like(color)).float()


# ---- the path tracer ----

def _onb(n):
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    return (torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], -1),
            torch.stack([b, s + ny * ny * a, -ny], -1))


def _unit(x):
    return x / torch.sqrt(bvh._dot(x, x))[:, None]


def _reflect(d, n):
    return d - (2.0 * bvh._dot(d, n))[:, None] * n


def path_trace(rs: RefScene, views, width, height, spp: int, gen: torch.Generator,
               max_depth=4, rr_start=2, work: Work | None = None):
    """`spp` spectral paths through each pixel of `views`, a list of (camera,
    px, py), jittered uniformly, traced together -> (the mean RGB [P,3] in
    float32, the variance of a sample's luminance R + G + B about each
    pixel's mean [P]), the views' pixels in order. Each view draws its
    jitter in turn, sample-major (sample s of pixel i at s P_view + i)."""
    work = Work() if work is None else work
    dev, dt = views[0][1].device, rs.dtype
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev, dtype=torch.float32).to(dt)
    starts = []
    for cam, px, py in views:
        n = px.shape[0]
        o, d = camera_rays(cam, width, height, px.repeat(spp), py.repeat(spp),
                           jitter=rnd(n * spp, 2), dtype=dt)
        starts.append((o.reshape(spp, n, 3), d.reshape(spp, n, 3)))
    o = torch.cat([x[0] for x in starts], dim=1).reshape(-1, 3).contiguous()
    d = torch.cat([x[1] for x in starts], dim=1).reshape(-1, 3).contiguous()
    P = sum(px.shape[0] for _, px, _ in views)
    N = P * spp
    thr = torch.ones((N, 3), dtype=dt, device=dev)
    medium = torch.ones((N,), dtype=dt, device=dev)
    chan = torch.full((N,), 3, dtype=torch.int64, device=dev)
    alive = torch.ones((N,), dtype=torch.bool, device=dev)
    radiance = torch.zeros((N, 3), dtype=dt, device=dev)
    sky = torch.tensor(SKY_PATH, dtype=dt, device=dev)
    disp = torch.tensor(DISPERSION + (0.0,), dtype=dt, device=dev)
    nL = len(rs.light_kind)
    for depth in range(max_depth + 1):
        idx = torch.nonzero(alive)[:, 0]
        if idx.numel() == 0:
            break
        lo, ld, lt = o[idx], d[idx], thr[idx]
        h = trace(rs, lo, ld)
        work.rays += idx.numel()
        work.hits += int(h.hit.sum())
        work.slots += h.slots
        work.tests += h.tests
        u = rnd(idx.numel(), 7)
        mid = h.mat
        albedo = rs.albedo[mid]
        # one light, picked uniformly, with its shadow ray
        li = torch.clamp((u[:, 6] * nL).long(), max=nL - 1)
        I = torch.zeros_like(u[:, 0])
        so, sd, smax = torch.zeros_like(lo), torch.zeros_like(ld), torch.zeros_like(I)
        for k in range(nL):
            Ik, sok, sdk, smk = _light_terms(rs, h, k)
            pick = li == k
            I = torch.where(pick, Ik, I)
            so = torch.where(pick[:, None], sok, so)
            sd = torch.where(pick[:, None], sdk, sd)
            smax = torch.where(pick, smk, smax)
        smax = torch.where(h.hit & (I > 0.0), smax, torch.zeros_like(smax))
        blocked = _occluded(rs, so, sd, smax, work)
        I = I * (~blocked).to(dt)
        lighting = albedo * 0.1 + albedo * (_brdf(rs, mid) * I * nL)[:, None] * rs.light_color[li]
        shaded = _glass_blend(rs, mid, lighting)
        add = torch.where(h.hit[:, None], shaded * lt, sky[None, :] * lt)
        radiance.index_add_(0, idx, add)
        if depth == max_depth:
            break
        # the continuation
        n = h.normal
        entering = bvh._dot(ld, n) < 0.0
        nf = torch.where(entering[:, None], n, -n)
        t_, b_ = _onb(nf)
        r = torch.sqrt(u[:, 0])
        phi = (2.0 * math.pi) * u[:, 1]
        z = torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))
        dir_diffuse = _unit(t_ * (r * torch.cos(phi))[:, None] + b_ * (r * torch.sin(phi))[:, None]
                            + nf * z[:, None])
        fuzz = u[:, 0:3] * 2.0 - 1.0
        mirror = _reflect(ld, nf)
        dir_metal = _unit(mirror + rs.roughness[mid][:, None] * fuzz)
        absorbed = bvh._dot(dir_metal, nf) <= 0.0
        is_glass = rs.transmission[mid] > 0.0
        c0 = chan[idx]
        split = is_glass & (c0 >= 3)
        c1 = torch.where(split, torch.clamp((u[:, 5] * 3.0).long(), max=2), c0)
        mior = rs.ior[mid] + disp[c1]
        n1 = torch.where(entering, medium[idx], mior)
        n2 = torch.where(entering, mior, torch.ones_like(mior))
        eta = n1 / n2
        cos_i = torch.abs(bvh._dot(ld, nf))
        sin2 = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
        tir = sin2 > 1.0
        cos_t = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))
        refr = _unit(torch.where(tir[:, None], mirror,
                                 eta[:, None] * ld + (eta * cos_i - cos_t)[:, None] * nf))
        r0 = ((n1 - n2) / (n1 + n2)) ** 2
        fres = torch.clamp(r0 + (1.0 - r0) * (1.0 - cos_i) ** 5, 0.0, 1.0)
        refl = tir | (u[:, 3] < fres)
        is_metal = ~is_glass & (rs.metallic[mid] > 0.5)
        nd = torch.where(is_glass[:, None], torch.where(refl[:, None], mirror, refr),
                         torch.where(is_metal[:, None], dir_metal, dir_diffuse))
        off = torch.where(bvh._dot(nd, nf) >= 0.0, 1.0, -1.0).to(dt) * 1e-3
        t_new = lt * albedo
        onehot = (c1[:, None] == torch.arange(3, device=dev)[None, :]).to(dt)
        t_new = torch.where(split[:, None], t_new * 3.0 * onehot, t_new)
        live = h.hit & ~(is_metal & absorbed)
        if depth + 1 >= rr_start:
            p = torch.clamp(t_new.amax(dim=1), 0.05, 0.95)
            keep = u[:, 4] <= p
            t_new = torch.where((live & keep)[:, None], t_new / p[:, None], t_new)
            live = live & keep
        o[idx] = torch.where(live[:, None], h.point + nf * off[:, None], lo)
        d[idx] = torch.where(live[:, None], nd, ld)
        thr[idx] = torch.where(live[:, None], t_new, lt)
        medium[idx] = torch.where(live & is_glass,
                                  torch.where(refl, medium[idx],
                                              torch.where(entering, mior, torch.ones_like(mior))),
                                  medium[idx])
        chan[idx] = torch.where(live, c1, c0)
        alive[idx] = live
    rad = radiance.float().reshape(spp, P, 3)
    return rad.mean(dim=0), rad.sum(dim=2).var(dim=0)


# ---- the fly frame: G-buffer and edge-avoiding à-trous filter ----

B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)   # the B3 spline's taps
LUMINANCE = (0.2126, 0.7152, 0.0722)                            # Rec. 709


def gbuffer(rs: RefScene, o, d, work: Work | None = None):
    """The primary hits of rays o, d through pixel centres -> (unit
    geometric normal [N,3], 0 on a miss; depth [N], the ray's t, +inf on a
    miss; albedo [N,3], the material's times its base-colour map at level
    0, 1 on a miss)."""
    work = Work() if work is None else work
    h = trace(rs, o, d)
    work.rays += o.shape[0]
    work.hits += int(h.hit.sum())
    work.slots += h.slots
    work.tests += h.tests
    albedo = rs.albedo[h.mat]
    if rs.maps:
        tex = torch.where(h.hit, rs.base_map[h.mat], torch.full_like(h.mat, -1))
        albedo = albedo * sample_base(rs, tex, hit_uv(rs, o, d, h), torch.zeros_like(h.t))
    depth = torch.where(h.hit, h.t, torch.full_like(h.t, float("inf")))
    return h.normal, depth, torch.where(h.hit[:, None], albedo, torch.ones_like(albedo))


def percentile99(x: torch.Tensor) -> torch.Tensor:
    """The 99th percentile of the values of `x`, linearly interpolated
    between the order statistics around rank 0.99 (n - 1)."""
    v = torch.sort(x.reshape(-1)).values
    pos = 0.99 * (v.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def atrous(color, normal, depth, albedo, iterations: int, sigma_color: float = 0.45,
           sigma_normal: float = 64.0, sigma_depth: float = 0.02):
    """The edge-avoiding à-trous wavelet filter (Dammertz et al. 2010) with
    albedo demodulation (Schied et al. 2017) of a radiance image [H,W,3]
    along its G-buffer (normal [H,W,3], 0 on a miss; depth [H,W]; albedo
    [H,W,3]), in the colour's dtype, one tap after another:
      * a pixel is a hit where n.n > 0.25; colour is divided by
        max(albedo, 1e-2) before the passes and multiplied back after;
      * depth is taken in units of the 99th percentile of the hit depths
        (misses as 0) on every (H // 256)-th row and (W // 256)-th column;
      * pass k (from 0) takes the 5 x 5 B3 taps at a spacing of 2^k, each
        tap's pixel clamped to the frame's edge, weighted by
        max(n.n_q, 0)^sigma_normal (1 where both pixels are misses) times
        exp(-(dz / sigma_depth)^2 - (dl / (sigma_color / 2^k))^2), dl the
        demodulated luminance's difference; the pass is the weighted mean."""
    H, W = color.shape[:2]
    dt, dev = color.dtype, color.device
    hit = (normal * normal).sum(dim=-1) > 0.25
    demod = torch.clamp(albedo.to(dt), min=1e-2)
    c = color / demod
    zs = torch.where(hit, depth, torch.zeros_like(depth))[::max(1, H // 256), ::max(1, W // 256)]
    zscale = percentile99(zs) + 1e-6
    z = torch.where(hit, depth / zscale, torch.zeros_like(depth)).to(dt)
    n = normal.to(dt)
    for k in range(iterations):
        spacing = 1 << k
        r = 2 * spacing
        lum = c[..., 0] * LUMINANCE[0] + c[..., 1] * LUMINANCE[1] + c[..., 2] * LUMINANCE[2]
        # every field with a border of r copies of its edge pixels: a tap
        # is then a window of the bordered field
        ry = torch.clamp(torch.arange(-r, H + r, device=dev), 0, H - 1)[:, None]
        rx = torch.clamp(torch.arange(-r, W + r, device=dev), 0, W - 1)[None, :]
        bn, bhit, bz, blum, bc = (x[ry, rx] for x in (n, hit, z, lum, c))
        acc = torch.zeros_like(c)
        wsum = torch.zeros_like(lum)
        for j in range(5):
            y0 = r + (j - 2) * spacing
            for i in range(5):
                x0 = r + (i - 2) * spacing
                tap = lambda b: b[y0:y0 + H, x0:x0 + W]
                cos = torch.clamp(bvh._dot(n, tap(bn)), min=0.0)
                w_n = torch.where(~hit & ~tap(bhit), torch.ones_like(cos), cos ** sigma_normal)
                dz = (z - tap(bz)) / sigma_depth
                dl = (lum - tap(blum)) / (sigma_color / (1 << k))
                w = (B3[j] * B3[i]) * w_n * torch.exp(-(dz * dz + dl * dl))
                acc = acc + tap(bc) * w[..., None]
                wsum = wsum + w
        c = acc / wsum[..., None]
    return c * demod


# ---- present ----

def srgb_u8(x: torch.Tensor) -> torch.Tensor:
    """Linear RGB -> sRGB-encoded u8, rounded to nearest."""
    x = torch.clamp(x.float(), 0.0, 1.0)
    s = torch.where(x <= SRGB_CUT, x * 12.92,
                    1.055 * torch.pow(torch.clamp(x, min=SRGB_CUT), 1.0 / 2.4) - 0.055)
    return (torch.clamp(s, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
