"""The lower-precision control of a cell's check: the plain reference put in
the program's place, computed in bfloat16 (the configuration states float32
and runs no matrix product, so TF32 has nothing to round), and compared with
the float32 reference by the cell's own numbers, at the cell's own sizes.

    python3 benchmark/control.py --workload <cell> --seeds 11 22 33

One JSON line a seed: the numbers and the limits they are held to. The
benchmark's runs do not run it; a cell's limits lie between the largest
number its sound runs read and the smallest this control reads.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__" and __package__ in (None, ""):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.dirname(here))

import argparse      # noqa: E402
import json          # noqa: E402
import time          # noqa: E402


def control_numbers(config: dict, mix: dict, seed: int, device) -> dict:
    """The cell's numbers of its driver kind's control (`Driver.control`)."""
    from benchmark.drivers.common import Spans
    from benchmark.run import load_module

    drv = load_module("drivers", mix["driver"]).Driver(config, mix, seed, device, Spans())
    drv.plan()
    return drv.control(device)


def main(argv=None) -> int:
    import torch

    from benchmark.run import BENCH, ROOT, find_cell, load_json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = find_cell(load_json(ROOT, "BENCHMARK.json"), args.workload)
    config = load_json(BENCH, "configs", cell["config"] + ".json")
    mix = load_json(BENCH, "traffic", cell["traffic"] + ".json")
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        try:
            nums = control_numbers(config, mix, seed, device)
        except RuntimeError as e:        # a control that crashes has failed
            nums = {"error": repr(e)}
        print(json.dumps({"workload": args.workload, "seed": seed, "control": nums,
                          "limits": mix["limits"], "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
