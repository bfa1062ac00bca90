"""Texture atlas sampling: the plain PyTorch version.

The atlas is the guard-band layout of models/geometry.py::Textures, so the
four taps of a bilinear fetch are always the addresses a, a+1, a + srows*128
and a + srows*128 + 1: the sampler wraps the base texel only, with integer
math, and reads the taps directly. Wrap modes REPEAT / CLAMP_TO_EDGE /
MIRRORED_REPEAT; filtering nearest, bilinear, nearest-mip (from a footprint
`lam`), trilinear (two levels blended) or at an explicit per-ray `lod`.

The texture shade kernel (csrc/texsample.cuh) evaluates these formulas in
the same order. Functions are batched over rays: `idx` [N], uv [N,2] ->
RGBA [N,4] f32 in [0, 1].
"""

from __future__ import annotations

import math

import torch

from ..models.geometry import TEX_CHUNK, Textures

NO_TEXTURE = 0xFFFFFFFF
INV_255 = 1.0 / 255.0
SQRT2 = 1.4142135       # f32 sqrt(2): lod = floor(log2(foot * sqrt2)) rounds log2(foot)
_DEN_MAX = (254 << 6) | 63


def _f32(x: float, device) -> torch.Tensor:
    """A 0-d f32 constant made on `device` (no host copy, which would make
    the host wait for a CUDA device)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _log2_split(x: torch.Tensor):
    """Positive normal x = (1 + mant) * 2^e -> (e, mant) in x's dtype: the
    f32 exponent and mantissa fields read as numbers (exact; torch.frexp
    keeps the float64 evaluation of the plain path possible)."""
    m, e = torch.frexp(x)                  # x = m * 2^e, m in [0.5, 1)
    return (e - 1).to(x.dtype), m * 2.0 - 1.0


def uv_density_code(tri_e1: torch.Tensor, tri_e2: torch.Tensor,
                    tri_uv: torch.Tensor) -> torch.Tensor:
    """Per-triangle mip uv density as a 14-bit float code [T] int32:
    density = sqrt(|uv cross| / |e1 x e2|) (texels per world unit at unit
    texture size), code = its f32 bits rounded to the top 14 below the sign
    (8-bit exponent, 6-bit mantissa), clipped below inf/NaN. Degenerate uvs
    (padding slots) give code 0, which decodes to 0.0. Computed once per scene:
    every pipeline decodes the same value, so they pick the same mip level."""
    e1, e2 = tri_e1, tri_e2
    cx = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
    cy = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
    cz = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    n2 = torch.clamp(cx * cx + cy * cy + cz * cz, min=1e-30)
    uv = tri_uv
    cruv = ((uv[:, 1, 0] - uv[:, 0, 0]) * (uv[:, 2, 1] - uv[:, 0, 1])
            - (uv[:, 2, 0] - uv[:, 0, 0]) * (uv[:, 1, 1] - uv[:, 0, 1]))
    den = torch.sqrt(torch.abs(cruv) * torch.rsqrt(n2))
    bits = den.view(torch.int32)
    return torch.clamp((bits + 0x10000) >> 17, 0, _DEN_MAX)


def den_decode(code: torch.Tensor) -> torch.Tensor:
    """14-bit density code -> f32 density (bits = code << 17)."""
    return (code.to(torch.int32) << 17).view(torch.float32)


def _unpack_rgba(texel: torch.Tensor) -> torch.Tensor:
    """[N] unsigned RGBA8 words (int64) -> [N,4] f32 in [0, 1]."""
    c = torch.stack([((texel >> (8 * k)) & 0xFF) for k in range(4)], dim=-1)
    return c.to(torch.float32) * INV_255


def _wrap(coord: torch.Tensor, size: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """Integer texel coordinates wrapped to [0, size)."""
    size = torch.clamp(size, min=1)
    repeat = torch.remainder(coord, size)
    clamp = torch.minimum(torch.clamp(coord, min=0), size - 1)
    per = torch.remainder(coord, 2 * size)
    mirror = torch.where(per < size, per, 2 * size - 1 - per)
    return torch.where(mode == 1, clamp, torch.where(mode == 2, mirror, repeat))


def _mirror_flip(coord: torch.Tensor, size: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """True where MIRRORED_REPEAT reflected this period: the +1 bilinear
    neighbour then lies at wrapped - 1, so the tap pair flips."""
    size = torch.clamp(size, min=1)
    return (mode == 2) & (torch.remainder(coord, 2 * size) >= size)


def _level_walk(tex: Textures, safe: torch.Tensor, lod: torch.Tensor):
    """Walk the mip chain to per-ray level `lod` (an integer-valued f32,
    already clamped to the chain) -> (w, h, srows, off_row) int64: level
    l+1 starts (h_l + 1) * srows_l rows after level l, with halved sizes."""
    w, h = tex.width[safe], tex.height[safe]
    sr, off = tex.srows[safe], tex.offset_row[safe]
    sw, sh, ssr, soff = w, h, sr, off
    for lv in range(1, tex.n_levels):
        off = off + (h + 1) * sr
        w = torch.clamp(w // 2, min=1)
        h = torch.clamp(h // 2, min=1)
        sr = (w + (TEX_CHUNK - 1)) // TEX_CHUNK
        m = lod >= float(lv)
        sw, sh = torch.where(m, w, sw), torch.where(m, h, sh)
        ssr, soff = torch.where(m, sr, ssr), torch.where(m, off, soff)
    return sw, sh, ssr, soff


def mip_lod_frac(tex: Textures, safe: torch.Tensor, lam: torch.Tensor):
    """Trilinear level split -> (floor level l0, blend frac), f32: log2 of
    the footprint as exponent + mantissa (piecewise linear, exact at level
    boundaries). frac is 0 when magnifying or at the chain's last level."""
    lv = tex.levels[safe].to(lam.dtype)
    foot = torch.clamp(lam * tex.width[safe].to(lam.dtype), min=1e-20)
    e, mant = _log2_split(foot)
    l0 = torch.minimum(torch.clamp(e, min=0.0), lv - 1.0)
    frac = torch.where((e >= 0.0) & (e < lv - 1.0), mant, torch.zeros_like(mant))
    return l0, frac


def mip_level_params(tex: Textures, safe: torch.Tensor, lam: torch.Tensor):
    """Nearest-mip level metadata -> (w, h, srows, off_row):
    lod = floor(log2(lam * w0 * sqrt2)) from the f32 exponent, clamped to
    the texture's chain."""
    lv = tex.levels[safe].to(lam.dtype)
    foot = torch.clamp(lam * tex.width[safe].to(lam.dtype), min=1e-20)
    e = _log2_split(foot * SQRT2)[0]
    lod = torch.minimum(torch.clamp(e, min=0.0), lv - 1.0)
    return _level_walk(tex, safe, lod)


def tap_base(tex: Textures, idx: torch.Tensor, uv: torch.Tensor,
             lam: torch.Tensor | None = None, lod: torch.Tensor | None = None):
    """Bilinear tap setup -> (row, lane, srows, fx, fy): the quad's taps are
    (row + {0, 1} * srows) * 128 + lane + {0, 1}. `idx` must be valid.
    MIRRORED_REPEAT's reflected periods fold into (lane, fx), CLAMP below
    the low edge gives weight 0. `lam` picks the nearest mip level of a
    pyramid atlas, an explicit `lod` overrides it."""
    safe = torch.clamp(idx, max=max(tex.count - 1, 0))
    mode = tex.wrap[safe]
    if lod is not None and tex.n_levels > 1:
        lv = tex.levels[safe].to(lod.dtype)
        lod = torch.minimum(torch.clamp(lod, min=0.0), lv - 1.0)
        w, h, srows, off_row = _level_walk(tex, safe, lod)
    elif lam is not None and tex.n_levels > 1:
        w, h, srows, off_row = mip_level_params(tex, safe, lam)
    else:
        w, h = tex.width[safe], tex.height[safe]
        srows, off_row = tex.srows[safe], tex.offset_row[safe]

    uf = uv[:, 0] * w.to(uv.dtype) - 0.5
    vf = uv[:, 1] * h.to(uv.dtype) - 0.5
    x0f, y0f = torch.floor(uf), torch.floor(vf)
    fx, fy = uf - x0f, vf - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    zero = torch.zeros_like(fx)

    def axis(c0, f, size):
        cw = _wrap(c0, size, mode)
        f = torch.where((mode == 1) & (c0 < 0), zero, f)
        flip = _mirror_flip(c0, size, mode)
        f = torch.where(flip, torch.where(cw == 0, zero, 1.0 - f), f)
        cw = torch.where(flip, torch.clamp(cw - 1, min=0), cw)
        return cw, f

    xw, fx = axis(x0, fx, w)
    yw, fy = axis(y0, fy, h)
    k = xw // TEX_CHUNK
    return off_row + yw * srows + k, xw - k * TEX_CHUNK, srows, fx, fy


def _bilinear_fetch(tex: Textures, safe, uv, lam=None, lod=None) -> torch.Tensor:
    """One bilinear fetch: the four taps read directly, each row's pair
    blended horizontally, then the two rows vertically."""
    row, lane, srows, fx, fy = tap_base(tex, safe, uv, lam=lam, lod=lod)
    a = row * 128 + lane
    b = a + srows * 128
    data = tex.data_u32

    def bytes_of(addr):
        t = data[addr][:, None]
        return ((t >> torch.tensor([0, 8, 16, 24], device=t.device)) & 0xFF).to(uv.dtype)

    gx, gy = (1.0 - fx)[:, None], (1.0 - fy)[:, None]
    top = bytes_of(a) * gx + bytes_of(a + 1) * fx[:, None]
    bot = bytes_of(b) * gx + bytes_of(b + 1) * fx[:, None]
    return (top * gy + bot * fy[:, None]) * INV_255


def sample_texture(tex: Textures, idx: torch.Tensor, uv: torch.Tensor,
                   bilinear: bool = True, lam: torch.Tensor | None = None,
                   trilinear: bool = False, lod: torch.Tensor | None = None) -> torch.Tensor:
    """Sample texture `idx` (NO_TEXTURE = none) at `uv` -> RGBA [N,4].
    Rays without a texture get opaque white, the identity factor. `lam`
    enables nearest-mip selection, `trilinear` blends the two levels around
    it instead; `lod` (an explicit level) and `trilinear` exclude each other."""
    valid = idx != NO_TEXTURE
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    if bilinear and trilinear and lam is not None and tex.n_levels > 1:
        sidx = torch.clamp(safe, max=max(tex.count - 1, 0))
        lv = tex.levels[sidx].to(lam.dtype)
        l0, frac = mip_lod_frac(tex, sidx, lam)
        r0 = _bilinear_fetch(tex, safe, uv, lod=l0)
        r1 = _bilinear_fetch(tex, safe, uv, lod=torch.minimum(l0 + 1.0, lv - 1.0))
        rgba = r0 * (1.0 - frac)[:, None] + r1 * frac[:, None]
    elif bilinear:
        rgba = _bilinear_fetch(tex, safe, uv, lam=lam, lod=lod)
    else:
        w, h, mode = tex.width[safe], tex.height[safe], tex.wrap[safe]
        x = _wrap(torch.floor(uv[:, 0] * w.to(uv.dtype)).to(torch.int64), w, mode)
        y = _wrap(torch.floor(uv[:, 1] * h.to(uv.dtype)).to(torch.int64), h, mode)
        k = x // TEX_CHUNK
        addr = (tex.offset_row[safe] + y * tex.srows[safe] + k) * 128 + (x - k * TEX_CHUNK)
        rgba = _unpack_rgba(tex.data_u32[torch.clamp(addr, max=tex.data_u32.shape[0] - 1)])
    return torch.where(valid[:, None], rgba, torch.ones_like(rgba))


def interpolate_uv(tri_uv: torch.Tensor, tri_idx: torch.Tensor,
                   bu: torch.Tensor, bv: torch.Tensor) -> torch.Tensor:
    """Barycentric uv of winner slots `tri_idx` (clamped by the caller):
    uv0 * (1 - u - v) + uv1 * u + uv2 * v."""
    uvs = tri_uv[tri_idx]
    w0 = (1.0 - bu - bv)[:, None]
    return uvs[:, 0] * w0 + uvs[:, 1] * bu[:, None] + uvs[:, 2] * bv[:, None]


def sphere_uv(normal: torch.Tensor) -> torch.Tensor:
    """Equirectangular uv from the unit outward normal:
    u = 0.5 + atan2(z, x) / 2pi, v = 0.5 - asin(y) / pi."""
    dev = normal.device
    u = 0.5 + torch.atan2(normal[:, 2], normal[:, 0]) / _f32(2.0 * math.pi, dev)
    v = 0.5 - torch.asin(torch.clamp(normal[:, 1], -1.0, 1.0)) / _f32(math.pi, dev)
    return torch.stack([u, v], dim=-1)
