"""Bit packing of the reference's launch parameters: tile size in two
16-bit halves, four byte-wide flags, and the branchless selects, kept
bit-compatible for scene interchange and parity tests."""

from __future__ import annotations

import torch


def pack_tile_size(width: int, height: int) -> int:
    """width in the low 16 bits, height in the high 16, each clamped to u16."""
    return (min(width, 65535) & 0xFFFF) | ((min(height, 65535) & 0xFFFF) << 16)


def unpack_tile_size(packed: int) -> tuple[int, int]:
    return packed & 0xFFFF, (packed >> 16) & 0xFFFF


def pack_flags(color_channel: int, current_bounce_depth: int,
               max_bounce_depth: int, wavefront_mode: int) -> int:
    """channel | current << 8 | max << 16 | wavefront << 24, a byte each."""
    return ((color_channel & 0xFF)
            | ((current_bounce_depth & 0xFF) << 8)
            | ((max_bounce_depth & 0xFF) << 16)
            | ((wavefront_mode & 0xFF) << 24))


def color_channel(flags: int) -> int:
    return flags & 0xFF


def current_bounce_depth(flags: int) -> int:
    return (flags >> 8) & 0xFF


def max_bounce_depth(flags: int) -> int:
    return (flags >> 16) & 0xFF


def wavefront_mode(flags: int) -> int:
    return (flags >> 24) & 0xFF


def branchless_u32_if(condition: bool, if_true: int, if_false: int) -> int:
    """t ^ ((t ^ f) & (cond - 1)) in wrapping u32 arithmetic."""
    mask = ((1 if condition else 0) - 1) & 0xFFFFFFFF
    return (if_true ^ ((if_true ^ if_false) & mask)) & 0xFFFFFFFF


F32_MAX = 3.4028235e38


def branchless_float_if(condition, if_true, if_false):
    """NaN-safe branchless float select -> (value, is_valid) as f32 tensors:
    each arm is clamped to f32::MAX and a NaN arm becomes f32::MAX; the
    chosen arm is used where it is below f32::MAX - 1, else the other one,
    so a NaN arm yields the other arm whatever the condition, and two NaN
    arms yield (f32::MAX, False). Scalars or tensors."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    mx = f32(F32_MAX)
    lim = f32(F32_MAX - 1.0)
    t, f = f32(if_true), f32(if_false)
    at = torch.where(torch.isnan(t), mx, torch.minimum(t, mx))
    af = torch.where(torch.isnan(f), mx, torch.minimum(f, mx))
    true_contrib = torch.where(at < lim, at, af)
    false_contrib = torch.where(af < lim, af, at)
    res = torch.where(torch.as_tensor(condition), true_contrib, false_contrib)
    return res, res < lim
