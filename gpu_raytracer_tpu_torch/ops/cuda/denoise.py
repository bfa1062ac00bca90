"""The edge-avoiding à-trous filter on a CUDA device: hand-written kernels
(csrc/atrous.cu, the arithmetic and tiling in csrc/atrous.cuh), a prepare
launch and one launch a pass.

It replaces no TPU kernel (the JAX package's filter is plain JAX); its plain
version is `ops/denoise.py::plain_atrous_denoise`, which CPU tensors take.
Per call:
  1. the prepare launch: the hit mask n.n > 0.25, the colour demodulated by
     max(albedo, 1e-2) (or not, without albedo) and its luminance, written
     as two float4 planes, (c.xyz, lum) and (n.xyz, depth), and the hit
     depths of the strided subsample that the depth scale is taken over;
  2. `torch.sort` of that subsample (65,536 depths at 1024^2), on the device;
  3. one launch a pass at dilation 2^it: each block first takes the depth
     scale, the sorted subsample's 99th percentile as the plain version's
     `torch.quantile` takes it (linear interpolation), plus 1e-6, never read
     by the host; it stages its tile of the field in shared memory, each
     thread sums its pixel's 25 taps in the JAX package's order and writes
     the next pass's colour plane; the last pass remodulates into the
     [H,W,3] frame.
So a call launches `iterations + 1` hand-written kernels (the prepare launch
alone for no pass), counted in build.py's LAUNCHES as denoise; the call is
the program span `denoise.atrous`. The colour, normal, depth and albedo may
be strided views whose pixels lie a fixed number of floats apart (the path
tracer's G-buffer planes are views of one [C,7] tensor); other layouts are
copied first."""

from __future__ import annotations

import torch

from ...engine.perf import span
from .build import check, load_kernels, tally

SUBSAMPLE_EDGE = 256        # frames above this many pixels an edge take every k-th row / column
MAX_ITERATIONS = 24         # the kernel's dilation 2^it is at most 2^23
ENTRIES = ("rt_atrous_prepare", "rt_atrous_pass")


def _integral_power(sigma_normal) -> int:
    """sigma_normal as the exponent of ops/denoise.py::_cos_power's repeated
    squaring (a Python number that is an integer in [1, 4096]), else 0."""
    if isinstance(sigma_normal, (int, float)) and float(sigma_normal).is_integer() \
            and 1 <= int(sigma_normal) <= 4096:
        return int(sigma_normal)
    return 0


def _pixel_rows(t: torch.Tensor, n: int, channels: int, name: str):
    """t ([H,W,channels], or [H,W] for channels 0) as pixel rows -> (a tensor
    whose pixel p starts p * stride floats in, its channels next to each
    other; the stride). A view where the layout allows one, else a copy."""
    if t.dtype != torch.float32:
        raise ValueError(f"atrous_denoise: {name} is {t.dtype}, want float32")
    rows = t.reshape(n, channels) if channels else t.reshape(n)
    if channels and rows.stride(1) != 1:
        rows = rows.contiguous()
    return rows, rows.stride(0)


def _entries(*names):
    """The kernel library's entry points `names`; raises if it lacks one."""
    k = load_kernels()
    fns = tuple(getattr(k.lib, name, None) for name in names)
    if None in fns:
        raise RuntimeError(f"atrous_denoise: the kernel library lacks one of {names}")
    return fns


def atrous_denoise(color: torch.Tensor, normal: torch.Tensor, depth: torch.Tensor,
                   albedo: torch.Tensor | None = None, *, iterations: int = 4,
                   sigma_color: float = 0.45, sigma_normal: float = 64.0,
                   sigma_depth: float = 0.02) -> torch.Tensor:
    """ops/denoise.py::atrous_denoise on CUDA tensors, through the kernels ->
    [H,W,3] f32 on their device. Raises for inputs the kernels do not take;
    never takes the plain version."""
    kernels = _entries(*ENTRIES)
    if color.dim() != 3 or color.shape[2] != 3:
        raise ValueError(f"atrous_denoise: color is {tuple(color.shape)}, want [H,W,3]")
    H, W = color.shape[0], color.shape[1]
    dev = color.device
    shapes = ((normal, (H, W, 3), "normal"), (depth, (H, W), "depth"))
    if albedo is not None:
        shapes += ((albedo, (H, W, 3), "albedo"),)
    for t, want, name in shapes:
        if tuple(t.shape) != want or t.device != dev:
            raise ValueError(f"atrous_denoise: {name} is {tuple(t.shape)} on {t.device}, "
                             f"want {want} on {dev}")
    if not 0 <= iterations <= MAX_ITERATIONS:
        raise ValueError(f"atrous_denoise: {iterations} iterations, want 0 .. {MAX_ITERATIONS}")
    if not isinstance(sigma_normal, (int, float)):
        raise ValueError("atrous_denoise: sigma_normal must be a Python number on CUDA")
    n = H * W
    if n == 0:
        return torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    with span("denoise.atrous"):
        rows = [_pixel_rows(color, n, 3, "color"), _pixel_rows(normal, n, 3, "normal"),
                _pixel_rows(depth, n, 0, "depth"),
                (None, 0) if albedo is None else _pixel_rows(albedo, n, 3, "albedo")]
        out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
        if iterations == 0:
            _prepare(kernels[0], rows, H, W, dev, out=out)
            return out
        planes, sub = _prepare(kernels[0], rows, H, W, dev)
        sub = torch.sort(sub).values
        a_rows, a_stride = rows[3]
        power = _integral_power(sigma_normal)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for it in range(iterations):
            last = it == iterations - 1
            tally("denoise")
            check(kernels[1](planes[it % 2].data_ptr(), planes[2].data_ptr(), sub.data_ptr(),
                             sub.numel(), H, W, 1 << it, sigma_color / (1 << it), sigma_depth,
                             float(sigma_normal), power,
                             None if last else planes[(it + 1) % 2].data_ptr(),
                             a_rows.data_ptr() if last and a_rows is not None else None,
                             a_stride, out.data_ptr() if last else None, stream),
                  "rt_atrous_pass")
        return out


def _prepare(prepare, rows, H: int, W: int, dev, out=None):
    """The prepare launch -> (planes [3,H*W,4] f32: the colour plane, the
    next pass's, the geometry plane; the depth scale's subsample [n] f32),
    both on the device; or, given `out` (a call of no pass), the prepare
    launch alone filling out with the remodulated colour, and (None, None)."""
    ptrs = [(None if t is None else t.data_ptr(), stride) for t, stride in rows]
    args = [v for pair in ptrs for v in pair] + [H, W]
    stream = torch.cuda.current_stream(dev).cuda_stream
    tally("denoise")
    if out is not None:
        check(prepare(*args, 1, 1, None, None, None, out.data_ptr(), stream),
              "rt_atrous_prepare")
        return None, None
    # the depth scale's subsample: every sy-th row and sx-th column
    sy, sx = max(1, H // SUBSAMPLE_EDGE), max(1, W // SUBSAMPLE_EDGE)
    sub = torch.empty((-(-H // sy)) * (-(-W // sx)), dtype=torch.float32, device=dev)
    planes = torch.empty((3, H * W, 4), dtype=torch.float32, device=dev)   # c, c', geometry
    check(prepare(*args, sy, sx, planes[0].data_ptr(), planes[2].data_ptr(), sub.data_ptr(),
                  None, stream), "rt_atrous_prepare")
    return planes, sub
