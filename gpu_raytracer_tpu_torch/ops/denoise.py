"""Edge-avoiding à-trous wavelet denoiser for the progressive path tracer:
the plain PyTorch counterpart of `gpu_raytracer_tpu/ops/denoise.py`.

After Dammertz et al. 2010 ("Edge-Avoiding À-Trous Wavelet Transform for
fast Global Illumination Filtering") with SVGF-style albedo demodulation
(Schied et al. 2017). Per call:
  1. demodulate colour by the primary-hit albedo (texture detail lives in
     the albedo factor and comes back verbatim; only illumination is
     filtered),
  2. `iterations` à-trous passes, 5x5 B3-spline taps at dilation 2^i,
     edge-stopped by luminance / normal / depth weights,
  3. remodulate.

The operations and their order are the JAX package's: the hit mask
n.n > 0.25, demodulation by max(albedo, 1e-2), the depth scale as the 99th
percentile (linear interpolation) of the hit depths on a strided subsample,
edge-clamped taps, the miss/miss rule (w_n = 1 where both pixels are
misses), the integral cosine power as repeated squaring, one fused
exp(-(dz^2 + dl^2)), acc / wsum, remodulation.

CUDA tensors take the hand-written kernels (ops/cuda/denoise.py: a prepare
launch and one launch a pass, the taps summed in the JAX package's order);
CPU tensors take the plain version, `plain_atrous_denoise`. One thing in it
differs from the JAX package, the batching: each pass stacks its 25
edge-clamped shifted views of one packed field [H,W,9] (colour, normal,
depth, luminance, hit) and computes the weights and the weighted sums over
the stack. The JAX sum runs over the taps one after another; the stacked
reduction adds them in another order, so the result moves by rounding only.
"""

from __future__ import annotations

import torch

from .cuda import denoise as cuda_denoise

# 1D B3-spline coefficients; the 5x5 kernel is their outer product
# (Dammertz Sec. 3). Sum = 1.
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
_LUM = (0.2126, 0.7152, 0.0722)  # Rec.709 luminance


def _pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-clamp pad by r on both spatial axes of [H,W,...] (jnp.pad
    mode="edge"): one gather of clamped row and column indices."""
    H, W = img.shape[0], img.shape[1]
    rows = torch.clamp(torch.arange(-r, H + r, device=img.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-r, W + r, device=img.device), 0, W - 1)
    return img[rows[:, None], cols[None, :]]


def _tap(padded: torch.Tensor, r: int, dy: int, dx: int, H: int, W: int) -> torch.Tensor:
    """out[y, x] = img[clamp(y+dy), clamp(x+dx)] as a slice of the r-padded
    buffer (|dy|, |dx| <= r)."""
    sy, sx = r + dy, r + dx
    return padded[sy:sy + H, sx:sx + W]


def _cos_power(x: torch.Tensor, sigma_normal) -> torch.Tensor:
    """x ** sigma_normal for x in [0,1]; a Python exponent that is a small
    integer runs as repeated squaring, in the JAX package's multiply
    order."""
    if isinstance(sigma_normal, (int, float)) and float(sigma_normal).is_integer() \
            and 1 <= int(sigma_normal) <= 4096:
        e = int(sigma_normal)
        out = None
        sq = x
        while e:
            if e & 1:
                out = sq if out is None else out * sq
            e >>= 1
            if e:
                sq = sq * sq
        return out
    return x ** sigma_normal


def _const(values, dev) -> torch.Tensor:
    """A small f32 constant on `dev`; bound for a CUDA device it goes in one
    pinned, non-blocking copy, so the host never waits for the card."""
    x = torch.tensor(values, dtype=torch.float32)
    return x.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else x


def atrous_denoise(color: torch.Tensor, normal: torch.Tensor, depth: torch.Tensor,
                   albedo: torch.Tensor | None = None, *, iterations: int = 4,
                   sigma_color: float = 0.45, sigma_normal: float = 64.0,
                   sigma_depth: float = 0.02) -> torch.Tensor:
    """Filter a noisy radiance image along G-buffer edges
    (`plain_atrous_denoise` states the contract): the kernels for CUDA
    tensors, the plain version for CPU tensors."""
    kw = dict(iterations=iterations, sigma_color=sigma_color, sigma_normal=sigma_normal,
              sigma_depth=sigma_depth)
    if color.device.type == "cuda":
        return cuda_denoise.atrous_denoise(color, normal, depth, albedo, **kw)
    if color.device.type != "cpu":
        raise ValueError(f"atrous_denoise: unsupported device {color.device}")
    return plain_atrous_denoise(color, normal, depth, albedo, **kw)


def plain_atrous_denoise(color: torch.Tensor, normal: torch.Tensor, depth: torch.Tensor,
                         albedo: torch.Tensor | None = None, *, iterations: int = 4,
                         sigma_color: float = 0.45, sigma_normal: float = 64.0,
                         sigma_depth: float = 0.02) -> torch.Tensor:
    """Filter a noisy radiance image along G-buffer edges.

    color  [H,W,3] linear radiance (the PathTracer accumulator mean)
    normal [H,W,3] primary-hit shading normal, exactly 0 on a miss
    depth  [H,W]   primary-hit ray t (any value on a miss; miss pixels are
                   isolated by the zero normal, not by depth)
    albedo [H,W,3] demodulation factor (None = no demodulation)

    sigma_color is in demodulated-luminance units and halves every
    iteration; sigma_normal is the cosine-power edge stop; sigma_depth is
    relative to the 99th-percentile hit depth. Runs on the tensors' device;
    nothing is read back to the host."""
    dev, f32 = color.device, torch.float32
    full = lambda v: torch.full((), v, dtype=f32, device=dev)   # no host copy
    hit = (normal * normal).sum(dim=-1) > 0.25                  # [H,W]
    if albedo is not None:
        demod = torch.clamp(albedo, min=1e-2)
        c = color / demod
    else:
        demod = None
        c = color

    # Depth in units of the hit-depth scale: the 99th percentile of the hit
    # depths, on a strided subsample of frames above 256 pixels an edge.
    H, W = c.shape[0], c.shape[1]
    sy, sx = max(1, H // 256), max(1, W // 256)
    zs = torch.where(hit, depth, full(0.0))[::sy, ::sx]
    zscale = torch.quantile(zs.reshape(-1), 0.99) + 1e-6
    z = torch.where(hit, depth / zscale, full(0.0))             # [H,W]

    n = normal
    lum_w = _const(_LUM, dev)
    h = _const([hy * hx for hy in _B3 for hx in _B3], dev)[:, None, None]   # [25,1,1]
    s_depth = full(sigma_depth)
    for it in range(iterations):
        step = 1 << it
        r = 2 * step
        lum = (c * lum_w).sum(dim=-1)                           # [H,W]
        packed = torch.cat([c, n, z[..., None], lum[..., None], hit[..., None].to(f32)],
                           dim=-1)
        padded = _pad(packed, r)
        taps = torch.stack([_tap(padded, r, (j - 2) * step, (i - 2) * step, H, W)
                            for j in range(5) for i in range(5)])   # [25,H,W,9]
        cq, nq, zq, lq = taps[..., 0:3], taps[..., 3:6], taps[..., 6], taps[..., 7]
        hq = taps[..., 8] > 0.5
        # miss pixels carry n = 0: the dot kills every hit<->miss pair, and
        # a miss<->miss pair counts as matched, or a miss pixel's own centre
        # tap would vanish too (0/0)
        w_n = torch.where(~hit & ~hq, full(1.0),
                          _cos_power(torch.clamp((n * nq).sum(dim=-1), min=0.0),
                                     sigma_normal))
        dz = (z - zq) / s_depth
        dl = (lum - lq) / full(sigma_color / (1 << it))
        w_zl = torch.exp(-(dz * dz + dl * dl))
        w = h * w_n * w_zl                                      # [25,H,W]
        acc = (cq * w[..., None]).sum(dim=0)
        wsum = w.sum(dim=0)
        c = acc / wsum[..., None]

    if demod is not None:
        c = c * demod
    return c
