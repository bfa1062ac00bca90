"""The inputs: the same seed gives the same ones, another seed others, and
the frozen courtyard generator gives what the program's own generator
(utils/procgen.py) gives today."""

import numpy as np
import pytest
import torch

from benchmark import scenes, generator
from benchmark.drivers.common import make_inputs, program_config, program_scene

from .conftest import tiny_cell

SEEDS = (7, 2 ** 31 + 12345, -3)


def _events(seed, n=300):
    _, _, config, mix = tiny_cell("courtyard-100k.orbit-1080p")
    inp = make_inputs(config, seed)
    ev = generator.CameraInputs(seed, inp.camera_position, inp.camera_direction, inp.extent, mix,
                              0.1, 0.005)
    return [ev[i] for i in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_camera_inputs_repeat_for_a_seed(seed):
    assert _events(seed) == _events(seed)


def test_camera_inputs_differ_between_seeds():
    assert _events(SEEDS[0]) != _events(SEEDS[1])


def test_camera_inputs_keep_the_share_of_drags_and_keys():
    ev = _events(11, 4000)
    drags = sum(e[0] == "drag" for e in ev) / len(ev)
    assert 0.66 < drags < 0.74
    assert all(abs(e[1]) <= 20 and abs(e[2]) <= 20 for e in ev if e[0] == "drag")
    assert {e[1] for e in ev if e[0] == "key"} == set("wasd")


def test_pixels_frames_and_scenes_follow_the_seed():
    a = generator.pick_pixels(5, generator.PIXELS, 100, 64, 48)
    assert all(np.array_equal(x, y) for x, y in zip(a, generator.pick_pixels(5, generator.PIXELS,
                                                                            100, 64, 48)))
    assert not np.array_equal(a[0], generator.pick_pixels(6, generator.PIXELS, 100, 64, 48)[0])
    assert len(set(zip(*a))) == 100
    assert generator.frame_picks(5, 10, 50, 4) == generator.frame_picks(5, 10, 50, 4)
    assert all(10 <= i < 60 for i in generator.frame_picks(5, 10, 50, 4))
    assert generator.scene_seed(5) == generator.scene_seed(5) != generator.scene_seed(6)


def test_scene_counts_do_not_depend_on_the_seed():
    a, b = (scenes.courtyard(3000, seed=s, textured=True, texture_size=256) for s in (1, 2))
    assert a.faces.shape == b.faces.shape and a.vertices.shape == b.vertices.shape
    assert [im.shape for im in a.images] == [im.shape for im in b.images]
    assert not np.array_equal(a.vertices, b.vertices)


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("seed", [0, 1234])
def test_frozen_generator_matches_the_programs(textured, seed):
    """Through the program's builders, the frozen copy's arrays give the
    scene the program's make_courtyard_scene gives: mesh, materials, lights,
    camera and every map."""
    from gpu_raytracer_tpu_torch.config import RaytracerConfig
    from gpu_raytracer_tpu_torch.models.geometry import JAX_ATLAS_BUDGET_ROWS
    from gpu_raytracer_tpu_torch.utils import procgen

    rt = RaytracerConfig()
    old = procgen.os.environ.get(procgen.CACHE_ENV)
    procgen.os.environ[procgen.CACHE_ENV] = ""
    try:
        want = procgen.make_courtyard_scene(3000, seed=seed, config=rt, textured=textured,
                                            texture_size=256)
    finally:
        if old is None:
            procgen.os.environ.pop(procgen.CACHE_ENV)
        else:
            procgen.os.environ[procgen.CACHE_ENV] = old
    inp = scenes.courtyard(3000, seed=seed, textured=textured, texture_size=256)
    got = program_scene(inp, rt, "cpu", JAX_ATLAS_BUDGET_ROWS if textured else None)
    for field in ("vertices", "indices", "material_id", "uv"):
        assert torch.equal(getattr(got.mesh, field), getattr(want.mesh, field)), field
    for obj in ("materials", "lights", "camera"):
        g, w = getattr(got, obj), getattr(want, obj)
        for k, v in vars(w).items():
            gv = getattr(g, k)
            assert (torch.equal(gv, v) if isinstance(v, torch.Tensor) else gv == v), (obj, k)
    assert torch.equal(got.tri_v0, want.tri_v0) and torch.equal(got.tri_mat, want.tri_mat)
    if textured:
        assert torch.equal(got.textures.data_u32, want.textures.data_u32)
        src = procgen.courtyard_source_images(seed, 256)
        assert all(np.array_equal(a, b) for a, b in zip(inp.images, src))


def test_program_config_is_the_configurations():
    _, _, config, _ = tiny_cell("courtyard-100k.progressive-1024")
    rt = program_config(config)
    assert (rt.bvh_width, rt.bvh_leaf_size, rt.max_bounce_depth,
            rt.russian_roulette_start) == (4, 8, 4, 2)
