"""Random number generation.

Two generators:

* `lcg_*`: the reference's per-pixel LCG (Numerical Recipes constants,
  `next_f32 = (u >> 8) / 2^24`, pixel seed `frame_seed + x + y*width`),
  bit-exact with the JAX package's. Unsigned 32-bit values are held in
  int64 tensors and wrapped with `& 0xFFFFFFFF` after every step.
* `sample_uniform` / `bounce_key`: independent U[0,1) streams from an
  explicit `torch.Generator`, the path tracer's `sampler="rng"` mode. They
  stand in for the JAX package's threefry keys, whose bits PyTorch cannot
  reproduce: the two packages agree on these streams only statistically.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_LCG_A = 1664525
_LCG_C = 1013904223


def lcg_pixel_seed(frame_seed: int, px: torch.Tensor, py: torch.Tensor, width: int) -> torch.Tensor:
    """frame_seed + x + y*width, wrapping u32 arithmetic -> int64 [N]."""
    return (int(frame_seed) + px.long() + py.long() * int(width)) & MASK32


def lcg_next(state: torch.Tensor):
    """One LCG step -> (new_state, u32 value), both int64 in [0, 2^32)."""
    state = (state * _LCG_A + _LCG_C) & MASK32   # < 2^53: exact in int64
    return state, state


def lcg_next_f32(state: torch.Tensor):
    """Random f32 in [0, 1): (next_u32 >> 8) / 2^24."""
    state, u = lcg_next(state)
    return state, (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


def lcg_next_f32_signed(state: torch.Tensor):
    """Random f32 in [-1, 1)."""
    state, f = lcg_next_f32(state)
    return state, f * 2.0 - 1.0


def sample_uniform(gen: torch.Generator, shape, n: int, device=None) -> torch.Tensor:
    """n independent U[0,1) variates per element -> f32 [*shape, n]."""
    return torch.rand(tuple(shape) + (n,), generator=gen, dtype=torch.float32,
                      device=device if device is not None else gen.device)


def bounce_key(base_seed: int, sample_idx: int, depth: int, device="cpu") -> torch.Generator:
    """A generator seeded per (sample, bounce) from the base seed: replay-
    stable, and independent of the order in which bounces are drawn."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(base_seed) * 0x9E3779B1 + int(sample_idx) * 0x85EBCA6B
                     + int(depth) * 0xC2B2AE35) & 0xFFFFFFFFFFFF)
    return gen
