"""Faults planted in the program underneath a fly cell's timed path, each a
way its frame can go wrong that the check has to catch. The CPU tests
(tests/test_bench_faults.py) plant them at a tiny size; on the card they
are read at the cell's own size:

    python3 benchmark/faults.py --workload <cell> --faults <name> ... --seeds 1 2 3 --seconds 8

One JSON line a fault and seed: the numbers compared, their limits and
whether the run came out correct; a fault's run has to come out not correct.
`--faults none` plants nothing: sound runs of many seeds in one process. A
window shorter than the benchmark's `run_seconds` draws its compared frames
from as much shorter a stretch, so that it compares as many as a run does.

  * history_dropped: every move restarts the accumulation (the warp gone);
  * coset_skipped: a moving frame takes no new sample;
  * filter_skipped: the frame displayed is the mean, not filtered;
  * stale_gbuffer: the filter runs along the previous frame's G-buffer;
  * altered: every sample's colour x 1.3 where it is produced;
  * half: half of each coset's samples left out (zero), the mean over all;
  * unchanged: the Viewer's frames stop after the first two (set-up's).
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__" and __package__ in (None, ""):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.dirname(here))

import argparse      # noqa: E402
import contextlib    # noqa: E402
import io            # noqa: E402
import json          # noqa: E402
import time          # noqa: E402

FLY_FAULTS = ("history_dropped", "coset_skipped", "filter_skipped", "stale_gbuffer", "altered",
              "half", "unchanged")


def _after(n, broken, real):
    """Call `real` for the first n calls, then `broken`."""
    calls = {"n": 0}

    def f(*a, **k):
        calls["n"] += 1
        return real(*a, **k) if calls["n"] <= n else broken(*a, **k)
    return f


def plant_fly(fault: str, setattr_) -> None:
    """Plant `fault` with `setattr_(owner, name, value)` (pytest's
    monkeypatch.setattr, or Patches.set)."""
    import torch

    from gpu_raytracer_tpu_torch.engine import pathtracer as pt_mod
    from gpu_raytracer_tpu_torch.engine import viewer as vw_mod
    from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise

    PT = pt_mod.PathTracer
    if fault == "none":
        return
    if fault == "history_dropped":
        real = PT.set_camera
        setattr_(PT, "set_camera", lambda self, camera, temporal=False: real(self, camera, False))
    elif fault == "coset_skipped":
        setattr_(PT, "_coset_step", lambda self, m: None)
    elif fault == "filter_skipped":
        setattr_(PT, "denoised_frame", lambda self, iterations=4, u8=False, **kw:
                 self.image_device(u8=u8))
    elif fault == "stale_gbuffer":
        previous = {}

        def stale(self, iterations=4, u8=False, **kw):
            now = self.gbuffer()
            normal, depth, albedo = previous.get(id(self), now)
            previous[id(self)] = now
            out = atrous_denoise(self.image_device(), normal, depth, albedo,
                                 iterations=iterations, **kw)
            return pt_mod.to_u8(out) if u8 else out
        setattr_(PT, "denoised_frame", stale)
    elif fault in ("altered", "half"):
        real_chunk = pt_mod._sample_chunk

        def broken(*a, **k):
            contrib, counts = real_chunk(*a, **k)
            if fault == "altered":
                return contrib * 1.3, counts
            keep = torch.ones_like(contrib)
            keep[contrib.shape[0] // 2:] = 0.0
            return contrib * keep, counts
        setattr_(pt_mod, "_sample_chunk", broken)
    elif fault == "unchanged":
        setattr_(vw_mod.Viewer, "run_compute",
                 _after(2, lambda self: 0, vw_mod.Viewer.run_compute))
    else:
        raise ValueError(f"no fault {fault!r}")


class Patches:
    """setattr with an undo: `set` as pytest's monkeypatch.setattr, `undo`."""

    def __init__(self):
        self.saved = []

    def set(self, owner, name, value) -> None:
        self.saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def undo(self) -> None:
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)


def main(argv=None) -> int:
    import torch

    from benchmark import run

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--faults", nargs="+", default=list(FLY_FAULTS))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    manifest = run.load_json(run.ROOT, "BENCHMARK.json")
    cell = run.find_cell(manifest, args.workload)
    config = run.load_json(run.BENCH, "configs", cell["config"] + ".json")
    mix = run.load_json(run.BENCH, "traffic", cell["traffic"] + ".json")
    scale = min(args.seconds / manifest["run_seconds"], 1.0)
    mix["expected_frames"] = max(int(mix["expected_frames"] * scale * 0.9), mix["check_frames"])
    run.set_caches()
    for fault in args.faults:
        for seed in args.seeds:
            patches = Patches()
            plant_fly(fault, patches.set)
            ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                    trace=0)
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                    rc = run.run_cell(ns, manifest, cell, config, mix, torch.device(args.device))
                line = json.loads(out.getvalue().strip().splitlines()[-1])
                ran = json.loads(next(x for x in err.getvalue().splitlines()
                                      if x.startswith("run "))[4:])
                res = {"correct": line["correct"], "compared": ran["compared"],
                       "check_s": ran["check_s"], "checks": line["checks"]}
            except Exception as e:       # a fault that crashes the run has failed it
                rc, res = None, {"error": repr(e)[:500]}
            finally:
                patches.undo()
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed, "rc": rc,
                              "seconds": time.perf_counter() - t0, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
