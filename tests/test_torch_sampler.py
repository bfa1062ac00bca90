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


def _np_pcg(x: np.ndarray) -> np.ndarray:
    """PCG output permutation in numpy uint32 (wrapping)."""
    x = x.astype(np.uint32)
    x = x * np.uint32(747796405) + np.uint32(2891336453)
    x = ((x >> ((x >> np.uint32(28)) + np.uint32(4))) ^ x) * np.uint32(277803737)
    return (x >> np.uint32(22)) ^ x


def _np_kernel_lattice(words, lanes: np.ndarray) -> np.ndarray:
    """The bounce kernel's QMC stream (csrc/bounce.cuh::qmc_uniforms) modelled
    in numpy uint32 arithmetic from the host words the kernel is handed:
    pid_base, sample_base, hd, chunk, seven generators, seven salts."""
    w = np.array(list(words), np.uint32)
    pid_base, sample_base, hd, chunk = w[0], w[1], w[2], int(w[3])
    alpha, salt = w[4:11], w[11:18]
    with np.errstate(over="ignore"):
        pid = pid_base + (lanes % chunk).astype(np.uint32)
        s = sample_base + (lanes // chunk).astype(np.uint32)
        h = _np_pcg(pid ^ hd)
        v = s[:, None] * alpha[None, :] + _np_pcg(h[:, None] + salt[None, :])
    return (v >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / 16777216.0)


@pytest.mark.parametrize("stream, depth", [((0, 0, 0, 1), 0), ((11, 3, 2**31 + 9, 2), 1),
                                           ((2**32 - 300, 2**32 - 2, U32_MAX, 4), 63),
                                           ((7, 2**31, 12345, 1), 4)])
def test_in_kernel_lattice_model_matches_qmc_uniforms_bit_for_bit(stream, depth):
    """What the bounce kernel computes from its launch arguments (two PCG
    hashes and seven multiply-adds per lane in native unsigned arithmetic,
    the depth hash from the host) equals `qmc_uniforms` at the lane's
    identity, and so the JAX package's numbers."""
    from gpu_raytracer_tpu_torch.ops.cuda.bounce import qmc_words
    from gpu_raytracer_tpu_torch.ops.wavefront import pool_uniforms

    q = sampler.QmcStream(*stream)
    n = 4096 * q.spp
    words = qmc_words(q, depth, n // q.spp)
    assert len(words) == 4 + 2 * sampler.N_DIMS
    assert list(words)[4:] == sampler.lattice_words()
    lanes = np.arange(n, dtype=np.int64)
    got = _np_kernel_lattice(words, lanes)
    want = pool_uniforms(q, depth, torch.arange(n), n).numpy()
    np.testing.assert_array_equal(got, want)
    C = n // q.spp
    pid = (q.pid_base + lanes % C).astype(np.uint32)
    s = (q.sample_base + lanes // C).astype(np.uint32)
    jax_want = np.asarray(jsampler.qmc_uniforms(jnp.asarray(pid), jnp.asarray(s), depth,
                                                np.uint32(q.seed)))
    np.testing.assert_array_equal(got, jax_want)
