"""The driver kinds own their check and their least times: on the cells of
the first benchmark, at the tiny size, the numbers and the least times the
driver gives are those that run.py's own choice by unit and textures gave
before the choice moved into the drivers (kept here as it was)."""

import json
import os
import types

import pytest
import torch

from benchmark import checks, roofline, run
from benchmark.drivers.common import Spans

from .conftest import TINY_SECONDS, tiny_cell


def choice_by_unit(driver, config, outputs, device):
    """run.py's dispatch before the drivers owned it: the check by the
    driver's unit, the least times by unit and by textures."""
    if driver.unit == "frame":
        nums, work, compared, tree_bytes = checks.viewer_check(driver, outputs, device)
    else:
        nums, work, compared, tree_bytes = checks.pathtracer_check(driver, outputs, device)
    inputs = driver.inputs
    tables = {"tree_bytes": tree_bytes,
              "materials": len(inputs.materials), "lights": len(inputs.lights),
              "texel_bytes": sum(int(im.shape[0]) * int(im.shape[1]) * 4 * 4 // 3
                                 for im in inputs.images)}
    lights = len(inputs.lights)
    if driver.unit == "step":
        paths = driver.width * driver.height
        depth = config["program"]["max_bounce_depth"] + 1
        least = {"k6": roofline.path_step(work, tables, paths, depth)["least_ms"]}
    elif inputs.images:
        pixels = driver.width * driver.height
        least = {"k3k4": roofline.textured_frame(work, tables, pixels, lights)["least_ms"]}
    else:
        pixels = driver.width * driver.height
        least = {"k2": roofline.whitted_frame(work, tables, pixels, lights)["least_ms"]}
    return nums, work, compared, least


@pytest.mark.parametrize("workload", ["courtyard-100k.orbit-1080p",
                                      "courtyard-100k.progressive-1024",
                                      "courtyard-100k-tex.orbit-1080p"])
def test_driver_owned_check_and_least_time_are_the_unit_choice(workload):
    _, _, config, mix = tiny_cell(workload)
    device = torch.device("cpu")
    driver = run.load_module("drivers", mix["driver"]).Driver(config, mix, 2 ** 31 + 5, device,
                                                              Spans())
    driver.setup()
    driver.run(seconds=TINY_SECONDS[mix["driver"]] / 4)
    outputs = driver.outputs()
    run.free(driver, device)
    nums, work, compared, tree_bytes = driver.check(outputs, device)
    want_nums, want_work, want_compared, want_least = choice_by_unit(driver, config, outputs,
                                                                     device)
    assert nums == want_nums and work == want_work and compared == want_compared
    assert driver.least_ms(work, tree_bytes) == want_least


def test_a_driver_kind_is_found_by_its_file_alone(capsys):
    """A driver kind of another unit, added as one file in the drivers'
    folder: run.py runs it, judges its numbers and prints its least times,
    with no file of the benchmark edited."""
    name = f"_throwaway_{os.getpid()}"
    path = os.path.join(run.BENCH, "drivers", name + ".py")
    cell = {"name": "courtyard-100k.tick", "config": "courtyard-100k", "traffic": "tick",
            "chips": 1}
    manifest = {"workloads": [cell], "per_layer": [],
                "end_to_end": [{"name": "tick_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}]}
    mix = {"driver": name, "limits": {"ticks_off": 0.1}, "trace_count": 1}
    args = types.SimpleNamespace(workload=cell["name"], seed=1, seconds=0.1, trace=0)
    try:
        with open(path, "w") as f:
            f.write(TICK)
        assert run.run_cell(args, manifest, cell, {}, mix, torch.device("cpu")) == 0
    finally:
        os.remove(path)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False and line["checks"] == {"ticks_off": {"value": 0.5,
                                                                          "limit": 0.1}}
    assert set(line["metrics"]) == {"tick_ms", "setup_s"}
    assert '"least_ms": {"tick": 0.75}' in err


TICK = """
class Driver:
    unit = "tick"

    def __init__(self, config, mix, seed, device, spans):
        self.cuda, self.label, self.window = False, None, {}

    def setup(self):
        return {}

    def run(self, seconds=None, count=None):
        self.window = {"ticks": 3}
        return {"tick_ms": 1.5, "attempted": 3, "failed": 0}

    def outputs(self):
        return {}

    def release(self):
        pass

    def check(self, outputs, device):
        return {"ticks_off": 0.5}, {"ticks": 3}, 3, 0

    def least_ms(self, work, tree_bytes):
        return {"tick": 0.25 * work["ticks"]}
"""
