"""Shared set-up of the benchmark's own tests: the `cuda` marker, and the
cells' configurations and mixes cut to a size the CPU runs in seconds."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# sizes at which a whole run of a cell takes seconds on the CPU
TINY_CONFIG = {"scene": {"triangles": 3000, "texture_size": 256, "atlas_budget_rows": 600},
               "frame_size": [64, 48], "pathtracer_size": [32, 32]}
TINY_MIX = {"viewer": dict(warm_frames=2, expected_frames=6, check_frames=3,
                           check_pixels=1000, trace_count=2),
            # no warm-up step: a step that leaves the accumulation as it was
            # then leaves it empty
            # a window of some hundred steps beside 256 paths of the reference,
            # so that a gap of a tenth of a pixel's brightness stands out
            "pathtracer": dict(warm_steps=0, check_pixels=256, check_spp=256, trace_count=2,
                               limits={"outlier_share": 0.03}),
            "fly": dict(still_frames=2, warm_frames=2, expected_frames=6, check_frames=2,
                        check_pixels=256, path_pixels=128, check_spp=64, trace_count=2,
                        # at 16^2 a pixel spans so much depth that the warp
                        # rejects about half of the history (0.40-0.57 read
                        # on sound runs); a dropped history leaves 0.75
                        limits={"gbuffer_off_share": 0.002, "filter_off_share": 0.002,
                                "filter_mean_abs": 0.0002, "empty_share": 0.66,
                                "outlier_share": 0.05, "luminance_gap": 0.1})}
# a kind's own sizes where the shared ones take the CPU too long: the fly
# frame's plain walk at 32^2 takes seconds a frame
TINY_KIND_CONFIG = {"fly": {"pathtracer_size": [16, 16]}}
TINY_SECONDS = {"viewer": 0.5, "pathtracer": 6.0, "fly": 3.0}     # a tiny run's window


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped on machines without one")


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def tiny_cell(workload: str):
    """(manifest, cell, config, mix) of a cell at the CPU's size: a cell of
    BENCHMARK.json, or <config>.<mix> of files the benchmark keeps."""
    manifest = load("BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        config_name, mix_name = workload.split(".", 1)
        cell = {"name": workload, "config": config_name, "traffic": mix_name, "chips": 1}
    config = load("benchmark", "configs", cell["config"] + ".json")
    mix = load("benchmark", "traffic", cell["traffic"] + ".json")
    for k, v in TINY_CONFIG.items():
        if isinstance(v, dict):
            config[k] = dict(config[k], **v)
        else:
            config[k] = v
    mix.update(TINY_MIX[mix["driver"]])
    config.update(TINY_KIND_CONFIG.get(mix["driver"], {}))
    return manifest, cell, config, mix


@pytest.fixture
def manifest():
    return load("BENCHMARK.json")
