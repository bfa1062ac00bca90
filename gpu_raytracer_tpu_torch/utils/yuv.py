"""YUV 4:2:0 packing of a display frame, for presenters that fetch frames
from the device: luma at full resolution, chroma 2x2-averaged, 1.5 bytes a
pixel against RGB's 3.

The encode runs on the frame's device, on the sRGB-encoded frame, with the
full-range BT.601 (JFIF) matrices. The decode unpacks on the host to RGB
u8 and rounds to nearest, as the encode does. (The JAX package's decode
truncates, which darkens every channel by half a count on average; this
one does not inherit that.)
"""

from __future__ import annotations

import numpy as np
import torch

from .image import linear_to_srgb


def encode_yuv420(img: torch.Tensor) -> torch.Tensor:
    """Linear [H,W,3] f32 (H, W even) -> packed u8 [H*3//2, W] on the
    image's device: rows 0..H-1 are Y; row H + k holds U's row k in
    columns 0..W//2 and V's row k in columns W//2..W. The sRGB encode comes
    before the matrix (chroma averages gamma-encoded values, as JFIF does)."""
    H, W = img.shape[0], img.shape[1]
    s = linear_to_srgb(img) * 255.0
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    sub = lambda c: c.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))
    chroma = torch.cat([sub(cb), sub(cr)], dim=1)          # [H/2, W]
    packed = torch.cat([y, chroma], dim=0)                 # [H*3/2, W]
    return (torch.clamp(packed, 0.0, 255.0) + 0.5).to(torch.uint8)


def decode_yuv420(packed) -> np.ndarray:
    """Packed u8 [H*3//2, W] (host array or tensor) -> display RGB u8
    [H,W,3] on the host, each channel rounded to nearest."""
    packed = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    H = packed.shape[0] * 2 // 3
    W = packed.shape[1]
    y = packed[:H].astype(np.float32)
    u = packed[H:, : W // 2].astype(np.float32) - 128.0
    v = packed[H:, W // 2:].astype(np.float32) - 128.0
    up = lambda c: np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)
    u = up(u)
    v = up(v)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return (np.clip(np.stack([r, g, b], axis=-1), 0.0, 255.0) + 0.5).astype(np.uint8)
