"""Low-discrepancy (quasi-Monte Carlo) sample streams for the path tracer.

    u[pixel, s, depth, dim] = frac(alpha_dim * s + rot(pixel, depth, dim))

A rank-1 lattice advanced in the sample index s (the generalised golden
ratio R_d recurrence, Roberts 2018), decorrelated across pixels, bounce
depths and dimensions by a Cranley-Patterson rotation drawn from a PCG
hash. Every u is uniform on [0, 1); within a pixel the s-sequence of each
dimension is stratified.

All arithmetic is wrapping uint32 fixed point, bit-exact with the JAX
package (alpha quantised to odd round(alpha * 2^32), the mapping
(v >> 8) * 2^-24 to [0, 1)). PyTorch has no unsigned 32-bit arithmetic, so
values live in int64 tensors in [0, 2^32) and every step is masked with
`& 0xFFFFFFFF`; a product of two 32-bit values (which would pass 2^63) is
split into 16-bit halves of one factor.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def _phi(d: int) -> float:
    """Unique positive root of x^(d+1) = x + 1 by Newton iteration."""
    x = 2.0
    for _ in range(64):
        x = x - (x ** (d + 1) - x - 1.0) / ((d + 1) * x ** d - 1.0)
    return x


def _alphas_q(d: int) -> np.ndarray:
    """The R_d lattice generator frac(phi_d^-(k+1)), k = 0..d-1, quantised
    to odd uint32 fixed point."""
    phi = _phi(d)
    a = np.array([(1.0 / phi) ** (k + 1) % 1.0 for k in range(d)])
    q = (np.round(a * 2.0 ** 32).astype(np.uint64) | 1) & 0xFFFFFFFF
    return q.astype(np.uint32)


# 7 dims per bounce (u layout of ops/wavefront.py: diffuse / fuzz x y, fuzz
# z, Fresnel, roulette, channel split, light pick) and the R_2 pair of the
# pixel jitter
N_DIMS = 7
_ALPHA7_Q = _alphas_q(N_DIMS)
_ALPHA2_Q = _alphas_q(2)
JITTER_TAG = 0xA11A50   # the jitter's "depth" in the rotation hash


@dataclass(frozen=True)
class QmcStream:
    """The identity of a chunk-major [spp, C] pool's lanes in the lattice:
    lane i is pixel id pid_base + i % C at sample index sample_base + i // C
    of the stream `seed` (a uint32 value)."""

    pid_base: int = 0
    sample_base: int = 0
    seed: int = 0
    spp: int = 1


def lattice_words(alphas_q: np.ndarray = _ALPHA7_Q) -> list[int]:
    """The per-dimension constants of `qmc_uniforms` as Python ints: the d
    generators, then the d rotation salts k * 0x85EBCA6B + 0x165667B1."""
    return ([int(a) for a in alphas_q]
            + [(k * 0x85EBCA6B + 0x165667B1) & MASK32 for k in range(len(alphas_q))])


def _u32(x):
    """An integer tensor -> int64 tensor in [0, 2^32); a Python int -> a
    Python int in [0, 2^32). Per-call scalars stay Python ints: a 0-d device
    tensor made from one would be a host-to-device copy that waits for the
    device."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def mul32(a, b):
    """(a * b) mod 2^32 for values in [0, 2^32) (tensors or Python ints): b
    split into 16-bit halves so that no partial product passes 2^48."""
    lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def pcg_hash(x):
    """PCG output permutation on uint32 (Jarzynski & Olano 2020), of a tensor
    or a Python int."""
    x = _u32(x)
    x = (x * 747796405 + 2891336453) & MASK32          # < 2^62
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK32
    return (x >> 22) ^ x


def _to_unit_f32(v: torch.Tensor) -> torch.Tensor:
    """[0, 1), never 1.0: the top 24 bits times 2^-24 (exact)."""
    return (v >> 8).to(torch.float32) * (1.0 / (1 << 24))


@functools.lru_cache(maxsize=None)
def _lattice(alphas: tuple, device: torch.device):
    """Per-dimension constants as [d] int64 tensors on `device`, made once:
    the generator's low and high 16 bits and the rotation salt
    k * 0x85EBCA6B + 0x165667B1."""
    words = lattice_words(np.array(alphas, np.uint32))
    a = torch.tensor(words[:len(alphas)], dtype=torch.int64, device=device)
    salt = torch.tensor(words[len(alphas):], dtype=torch.int64, device=device)
    return a & 0xFFFF, (a >> 16) & 0xFFFF, salt


def qmc_uniforms(pid: torch.Tensor, s: torch.Tensor, depth, seed,
                 alphas_q: np.ndarray = _ALPHA7_Q) -> torch.Tensor:
    """[N, d] Cranley-Patterson-rotated lattice uniforms, f32.

    pid   [N] stable pixel identity: the rotation axis;
    s     [N] global sample index of each lane;
    depth bounce depth (int or 0-d tensor), part of the rotation hash;
    seed  per-PathTracer stream seed (uint32 value).

    All d dimensions are computed as [N, d] tensors, one operation each (a
    loop over the dimensions would launch d times as many kernels)."""
    pid = _u32(pid)
    s = _u32(s)[:, None]
    hd = pcg_hash((mul32(_u32(depth), 0x9E3779B9) + _u32(seed)) & MASK32)
    h = pcg_hash(pid ^ hd)
    lo, hi, salt = _lattice(tuple(int(a) for a in alphas_q), pid.device)
    rot = pcg_hash((h[:, None] + salt) & MASK32)
    # mul32(s, alpha) + rot, masked once: every term is below 2^49
    return _to_unit_f32((s * lo + (((s * hi) & 0xFFFF) << 16) + rot) & MASK32)


def qmc_jitter(pid: torch.Tensor, s: torch.Tensor, seed) -> torch.Tensor:
    """[N, 2] pixel anti-aliasing jitter: the R_2 lattice in s, rotated per
    pixel."""
    return qmc_uniforms(pid, s, JITTER_TAG, seed, alphas_q=_ALPHA2_Q)
