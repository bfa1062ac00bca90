"""Image output: the sRGB display encode, a pure-Python PNG writer, PPM and
the RMSE fidelity metric.

Frames are linear; every u8 quantise on the way to a file applies the exact
piecewise IEC 61966-2-1 encode by default (srgb=False keeps raw linear).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_SRGB_CUT = 0.0031308  # linear-domain breakpoint
_SRGB_CUT_ENC = 0.04045  # encoded-domain breakpoint (12.92 * _SRGB_CUT)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """Exact piecewise sRGB transfer of a tensor clipped to [0, 1]."""
    x = torch.clamp(x, 0.0, 1.0)
    lo = x * 12.92
    hi = 1.055 * torch.pow(torch.clamp(x, min=_SRGB_CUT), 1.0 / 2.4) - 0.055
    return torch.where(x <= _SRGB_CUT, lo, hi)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """The inverse of `linear_to_srgb` (the electro-optical transfer) of a
    tensor clipped to [0, 1]."""
    x = torch.clamp(x, 0.0, 1.0)
    lo = x * (1.0 / 12.92)
    hi = torch.pow((torch.clamp(x, min=_SRGB_CUT_ENC) + 0.055) * (1.0 / 1.055), 2.4)
    return torch.where(x <= _SRGB_CUT_ENC, lo, hi)


def quantize_u8(x: torch.Tensor, srgb: bool = True) -> torch.Tensor:
    """Linear float tensor -> u8 on its device, round to nearest;
    sRGB-encoded by default."""
    if srgb:
        x = linear_to_srgb(x)
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def to_u8(img: np.ndarray, srgb: bool = True) -> np.ndarray:
    """[H,W,3] linear float -> u8 (`quantize_u8`); u8 input as it is."""
    if img.dtype == np.uint8:
        return img
    return quantize_u8(torch.from_numpy(np.ascontiguousarray(img, np.float32)), srgb).numpy()


def encode_png(img: np.ndarray, level: int = 6, srgb: bool = True) -> bytes:
    """[H,W,3] RGB or [H,W,4] RGBA -> PNG bytes. Float input is linear and
    gets the sRGB encode; uint8 input is written as it is."""
    img = to_u8(img, srgb=srgb)
    h, w = img.shape[:2]
    color_type = 6 if img.shape[-1] == 4 else 2
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, srgb: bool = True) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, srgb=srgb))


def write_ppm(path: str, img: np.ndarray, srgb: bool = True) -> None:
    """[H,W,3] float (linear, sRGB-encoded by default) or uint8 (as it is)
    -> a binary PPM (P6)."""
    img = to_u8(img, srgb=srgb)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def rmse(a, b) -> float:
    """Root mean square of a - b over every element, in float64: the
    fidelity metric of the frames against the oracle."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
