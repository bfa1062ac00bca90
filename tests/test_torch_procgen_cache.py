"""The courtyard atlas's disk cache (utils/procgen.py::courtyard_textures):
the four cases of the JAX package's tests/test_procgen_cache.py under the
port's own variable, GPU_RAYTRACER_TPU_TORCH_CACHE, plus a cached load that
really comes from the file and equals the JAX package's build, and a key
tied to the build's code."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_bridge  # noqa: F401  (thread cap)

from gpu_raytracer_tpu.utils.procgen import courtyard_textures as jax_courtyard_textures
from gpu_raytracer_tpu_torch.models.geometry import Textures
from gpu_raytracer_tpu_torch.utils import procgen
from gpu_raytracer_tpu_torch.utils.procgen import CACHE_ENV, courtyard_textures

ARGS = dict(mips=4, budget_rows=4096)


def _fields(tex):
    return {f.name: getattr(tex, f.name) for f in dataclasses.fields(type(tex))
            if f.name != "n_levels"}


def _assert_equal(a, b):
    assert a.n_levels == b.n_levels
    fb = _fields(b)
    for k, v in _fields(a).items():
        assert torch.equal(v, fb[k]), k


def test_cache_round_trip_bit_exact(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    a = courtyard_textures(3, 1024, **ARGS)
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == [f"ctex_{procgen.build_digest()}_s3_t1024_m4_b4096.npz"]

    def no_build(*a, **kw):
        raise AssertionError("a cached key was built again")

    monkeypatch.setattr(Textures, "from_images", staticmethod(no_build))
    b = courtyard_textures(3, 1024, **ARGS)
    _assert_equal(a, b)
    assert b.data_u32.device.type == "cpu" and b.data_u32.dtype == torch.int64


def test_cache_key_separates_params(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    courtyard_textures(3, 1024, **ARGS)
    courtyard_textures(4, 1024, **ARGS)
    assert len(list(tmp_path.iterdir())) == 2


def test_cache_disabled_and_small_sizes_skip(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV, "")
    assert procgen.cache_dir() == ""
    courtyard_textures(3, 1024, **ARGS)
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    courtyard_textures(3, 128, **ARGS)   # below the threshold
    assert list(tmp_path.iterdir()) == []


def test_cache_key_follows_the_build_code(tmp_path, monkeypatch):
    """A file that another build of the code wrote is not loaded: the key
    holds the digest of the build's source, which any edit changes."""
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    digest = procgen.build_digest()
    assert len(digest) == 16 and digest == procgen.build_digest()
    a = courtyard_textures(3, 1024, **ARGS)
    monkeypatch.setattr(procgen, "build_digest", lambda: "0" * 16)
    built = []
    from_images = Textures.from_images

    def counted(*a, **kw):
        built.append(1)
        return from_images(*a, **kw)

    monkeypatch.setattr(Textures, "from_images", staticmethod(counted))
    _assert_equal(a, courtyard_textures(3, 1024, **ARGS))
    assert built == [1]
    assert sorted(f.name.split("_")[1] for f in tmp_path.iterdir()) == sorted(["0" * 16, digest])


@pytest.mark.parametrize("content", [b"not an npz", b"PK\x03\x04 truncated zip"])
def test_corrupt_cache_falls_back_to_build(tmp_path, monkeypatch, content):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    a = courtyard_textures(3, 1024, **ARGS)
    (f,) = tmp_path.iterdir()
    f.write_bytes(content)
    b = courtyard_textures(3, 1024, **ARGS)
    _assert_equal(a, b)
    (g,) = tmp_path.iterdir()                      # rewritten, no temporary left
    assert g == f and g.stat().st_size > 1000
    _assert_equal(a, courtyard_textures(3, 1024, **ARGS))


def test_cached_atlas_equals_the_jax_build(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    monkeypatch.setenv("GPU_RAYTRACER_TPU_CACHE", "")
    courtyard_textures(1, 1024, **ARGS)
    got = courtyard_textures(1, 1024, **ARGS)     # from the file
    want = jax_courtyard_textures(1, 1024, **ARGS)
    assert got.n_levels == want.n_levels
    for k, v in _fields(got).items():
        w = np.asarray(getattr(want, k))
        assert np.array_equal(v.numpy(), w.astype(np.int64)), k
