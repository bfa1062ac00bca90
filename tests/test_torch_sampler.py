"""The port's random streams against the JAX package's: the reference LCG
and the QMC lattice (ops/sampler.py) bit for bit, with identities, sample
indices and seeds across the whole uint32 range; the torch.Generator
stream (`sampler="rng"`), which cannot match JAX's threefry bits, by its
range, shape and replay."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_bridge  # noqa: F401  (thread cap)

from gpu_raytracer_tpu.ops import rng as jrng
from gpu_raytracer_tpu.ops import sampler as jsampler
from gpu_raytracer_tpu_torch.ops import rng, sampler

U32_MAX = 2**32 - 1


def _u32_values(n: int, seed: int) -> np.ndarray:
    """Random uint32 values plus the edges: 0, 1, 2^31 +- 1, 2^32 - 2, 2^32 - 1."""
    r = np.random.default_rng(seed)
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, U32_MAX - 1, U32_MAX], np.uint64)
    return np.concatenate([r.integers(0, 2**32, n, dtype=np.uint64), edges]).astype(np.uint32)


def _torch_u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def test_lcg_matches_jax_bit_for_bit():
    r = np.random.default_rng(0)
    px = r.integers(0, 4096, 512).astype(np.int32)
    py = r.integers(0, 4096, 512).astype(np.int32)
    for frame_seed, width in ((0, 640), (2**31 + 12345, 4096), (U32_MAX, 1920)):
        js = jrng.lcg_pixel_seed(frame_seed, jnp.asarray(px), jnp.asarray(py), width)
        ts = rng.lcg_pixel_seed(frame_seed, torch.from_numpy(px), torch.from_numpy(py), width)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
        for _ in range(3):
            js, ju = jrng.lcg_next(js)
            ts, tu = rng.lcg_next(ts)
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju).astype(np.int64))
            js, jf = jrng.lcg_next_f32(js)
            ts, tf = rng.lcg_next_f32(ts)
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
            js, jg = jrng.lcg_next_f32_signed(js)
            ts, tg = rng.lcg_next_f32_signed(ts)
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_pcg_hash_matches_jax_bit_for_bit():
    x = _u32_values(4096, 1)
    want = np.asarray(jsampler.pcg_hash(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(sampler.pcg_hash(_torch_u32(x)).numpy(), want)


def test_lattice_generators_match_jax():
    for d in (2, 7):
        np.testing.assert_array_equal(sampler._alphas_q(d), jsampler._alphas_q(d))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, U32_MAX])
@pytest.mark.parametrize("depth", [0, 3, 63])
def test_qmc_uniforms_match_jax_bit_for_bit(seed, depth):
    pid = _u32_values(2048, 2)
    s = _u32_values(2048, 3)
    want = np.asarray(jsampler.qmc_uniforms(jnp.asarray(pid), jnp.asarray(s), depth,
                                            np.uint32(seed)))
    got = sampler.qmc_uniforms(_torch_u32(pid), _torch_u32(s), depth, seed).numpy()
    assert got.shape == (pid.shape[0], 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_qmc_jitter_matches_jax_bit_for_bit(seed):
    pid = _u32_values(2048, 4)
    s = _u32_values(2048, 5)
    want = np.asarray(jsampler.qmc_jitter(jnp.asarray(pid), jnp.asarray(s), np.uint32(seed)))
    np.testing.assert_array_equal(sampler.qmc_jitter(_torch_u32(pid), _torch_u32(s),
                                                     seed).numpy(), want)


def test_independent_stream_is_uniform_and_replays():
    a = rng.sample_uniform(rng.bounce_key(3, 5, 2), (10_000,), 7)
    b = rng.sample_uniform(rng.bounce_key(3, 5, 2), (10_000,), 7)
    c = rng.sample_uniform(rng.bounce_key(3, 5, 3), (10_000,), 7)
    assert a.shape == (10_000, 7) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min().item() >= 0.0 and a.max().item() < 1.0
    assert abs(a.mean().item() - 0.5) < 0.01
