"""f16 bit-packing helpers.

Material and light parameters are stored as IEEE half floats packed two per
32-bit word (low | high << 16), the same storage format as the JAX package,
so packed words compare bit for bit across the two packages. Packed words
live in int64 tensors holding the unsigned 32-bit value.

Packing happens on the host from Python floats. It stays in NumPy because
NumPy rounds float64 straight to float16, while torch rounds float64 to
float32 first and then to float16, which can differ on a tie.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_f16_pair(low, high) -> np.ndarray:
    """Host-side: pack two values into one u32 as (low f16 | high f16 << 16)."""
    lo = np.asarray(low, dtype=np.float16).view(np.uint16).astype(np.uint32)
    hi = np.asarray(high, dtype=np.float16).view(np.uint16).astype(np.uint32)
    return (lo | (hi << np.uint32(16))).astype(np.uint32)


def unpack_f16_pair_host(packed) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of `pack_f16_pair`: (low, high) as f32 arrays."""
    packed = np.asarray(packed).astype(np.uint32)
    lo = (packed & np.uint32(0xFFFF)).astype(np.uint16).view(np.float16).astype(np.float32)
    hi = (packed >> np.uint32(16)).astype(np.uint16).view(np.float16).astype(np.float32)
    return lo, hi


def _half_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """[..] integer tensor of 16-bit patterns (0..65535) -> float32."""
    signed = torch.where(bits >= 32768, bits - 65536, bits).to(torch.int16)
    return signed.view(torch.float16).to(torch.float32)


def unpack_f16_low(packed: torch.Tensor) -> torch.Tensor:
    """Decode the low 16 bits of each packed word as f16 -> f32."""
    return _half_bits_to_f32(packed.to(torch.int64) & 0xFFFF)


def unpack_f16_high(packed: torch.Tensor) -> torch.Tensor:
    """Decode the high 16 bits of each packed word as f16 -> f32."""
    return _half_bits_to_f32((packed.to(torch.int64) >> 16) & 0xFFFF)


def f16_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Round a f32 tensor through f16 precision (round to nearest even,
    subnormals kept): the light attenuation's f16 quantisation."""
    return x.to(torch.float16).to(torch.float32)
