"""A run with the timed path broken underneath comes out not correct: each
fault that a cell can have, planted in the program for the run, on the CPU
at a tiny size (the harness's look for a card skipped). The cells run on
one chip, so no fault of an exchange between chips applies. A fly cell's
faults are benchmark/faults.py's, which reads them on the card too."""

import pytest
import torch

from gpu_raytracer_tpu_torch.engine import pathtracer as pt_mod
from gpu_raytracer_tpu_torch.engine import renderer as rd_mod
from gpu_raytracer_tpu_torch.engine import viewer as vw_mod

from benchmark import faults

from .test_bench_run import CELLS, run_tiny

FLY_CELLS = [c for c in CELLS if ".fly-" in c]
FRAME_CELLS = [c for c in CELLS if "progressive" not in c and c not in FLY_CELLS]


def frame_faults(monkeypatch, fault):
    real_compute, real_rays = vw_mod.Viewer.run_compute, rd_mod.Renderer.render_rays
    if fault == "unchanged":       # frames stop following the inputs
        monkeypatch.setattr(vw_mod.Viewer, "run_compute",
                            faults._after(2, lambda self: 0, real_compute))
    elif fault == "half":          # half of each frame's pixels left out
        def half(self, px, py, light_salt=0):
            rgb = real_rays(self, px, py, light_salt)
            rgb[rgb.shape[0] // 2:] = 0.0
            return rgb
        monkeypatch.setattr(rd_mod.Renderer, "render_rays", half)
    else:                          # every answer altered where it is produced
        monkeypatch.setattr(rd_mod.Renderer, "render_rays",
                            lambda self, px, py, light_salt=0:
                            real_rays(self, px, py, light_salt) * 1.05)


def step_faults(monkeypatch, fault):
    real_chunk = pt_mod._sample_chunk
    if fault == "unchanged":       # steps return with the accumulation as it was
        monkeypatch.setattr(pt_mod.PathTracer, "step", lambda self: None)
    elif fault == "half":          # half of the pixels left out, the mean over the rest
        def half(*a, **k):
            contrib, counts = real_chunk(*a, **k)
            n = contrib.shape[0] // 2
            contrib = contrib.clone()
            contrib[n:] = 0.0
            return contrib, counts
        monkeypatch.setattr(pt_mod, "_sample_chunk", half)
    else:                          # the radiance altered where it is produced
        def altered(*a, **k):
            contrib, counts = real_chunk(*a, **k)
            return contrib * torch.tensor([1.3, 1.0, 1.0]), counts
        monkeypatch.setattr(pt_mod, "_sample_chunk", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch, capsys):
    if workload in FLY_CELLS:
        faults.plant_fly(fault, monkeypatch.setattr)
    elif workload in FRAME_CELLS:
        frame_faults(monkeypatch, fault)
    else:
        step_faults(monkeypatch, fault)
    rc, line, _ = run_tiny(workload, 0, capsys)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["history_dropped", "coset_skipped", "filter_skipped",
                                   "stale_gbuffer"])
@pytest.mark.parametrize("workload", FLY_CELLS)
def test_a_broken_fly_frame_is_not_correct(workload, fault, monkeypatch, capsys):
    """The fly frame's own faults (benchmark/faults.py): its history, its
    coset step, its filter and the G-buffer the filter runs along."""
    faults.plant_fly(fault, monkeypatch.setattr)
    rc, line, _ = run_tiny(workload, 0, capsys)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", FRAME_CELLS + FLY_CELLS)
def test_the_lower_precision_control_is_not_correct(workload):
    """The control (control.py): the reference in bfloat16 in the program's
    place fails the cell's limits, here at the CPU's size."""
    from benchmark import checks, control

    from .conftest import tiny_cell

    _, _, config, mix = tiny_cell(workload)
    nums = control.control_numbers(config, mix, 2 ** 31 + 7, torch.device("cpu"))
    assert not checks.judge(nums, mix["limits"])[0], nums
