#!/usr/bin/env python3
"""A/B timing of the traversing kernels on one GPU: two trees of this
repository, or one tree built with different compile-time settings, measured
in turn inside one run so that they share a card.

    python3 chip_ab.py --parent build/parent                # parent, change, change, parent
    python3 chip_ab.py --variants "RT_SHARED_STACK=0" "RT_RENDER_MIN_BLOCKS=8 RT_RENDER_BLOCK=64"
    python3 chip_ab.py --one [--root DIR] [--defines "A=1 B=2"]   # one measurement, one JSON line
    python3 chip_ab.py --sass                               # static SASS size of K1's loops

Unpack the other tree first (`git archive <commit> | tar -x -C build/parent`;
build/ is git-ignored). Every measurement is its own process, run from this
file but importing the package and chip_smoke.py of its `--root`, with the
given `-D` settings appended to the kernels' nvcc flags (csrc/traverse.cuh
names them). Each prints one JSON line: the card, the settings, ptxas's
registers and spills, and median milliseconds (`chip_smoke.timed`, CUDA
events) on the 100k-triangle courtyard:
  K1 on the 1920x1080 camera rays; K2 (render_primary) shadows off and on;
  K3 (render_deferred) on the textured courtyard; each in the row-major tile
  order and, where the tree has it, the 8 x 4 warp order;
  PathTracer.step() at 1024x1024 with K6's device time, the device's busy
  time and the host's enqueue time per sample (torch.profiler).
With `--out FILE` every line is also appended to FILE.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, PT_SIZE = 1920, 1080, 1024
LAUNCHES, REPEATS = 32, 3      # launches per median, medians per reading
PT_STEPS = 8


def measure(root: str, defines: list[str], label: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from gpu_raytracer_tpu_torch.engine.pathtracer import PathTracer
    from gpu_raytracer_tpu_torch.engine.renderer import tiled_pixel_order
    from gpu_raytracer_tpu_torch.ops.cuda import build
    from gpu_raytracer_tpu_torch.ops.cuda.render import (pack_render_tables, render_deferred,
                                                         render_primary)
    from gpu_raytracer_tpu_torch.ops.cuda.traverse import traverse
    from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene

    build.NVCC_FLAGS = (*build.NVCC_FLAGS, *(f"-D{d}" for d in defines))
    k = build.load_kernels()
    device = torch.device("cuda", 0)
    out = dict(label=label, root=os.path.relpath(root, HERE), defines=defines,
               card=cs.card_line(), nvcc_s=k.seconds)
    ptxas = cs.ptxas_summary(k.log)
    out["ptxas"] = {name: v for name, v in ptxas.items()
                    if name.startswith(("traverse_kernel<32, 0", "render_primary_kernel<32, 0",
                                        "render_deferred_kernel<32", "bounce_kernel<32, 0, 2"))}

    def reading(fn):
        return [cs.timed(fn, LAUNCHES, device) for _ in range(REPEATS)]

    scene = make_courtyard_scene(100_000, seed=0, device=device)
    tables = pack_render_tables(scene)
    tscene = make_courtyard_scene(100_000, seed=0, textured=True, texture_size=1024,
                                  device=device)
    ttables = pack_render_tables(tscene)
    orders = {"rows": tiled_pixel_order(WIDTH, HEIGHT)}
    if "warp" in inspect.signature(tiled_pixel_order).parameters:
        orders["warp8x4"] = tiled_pixel_order(WIDTH, HEIGHT, warp=(8, 4))
    far = torch.full((WIDTH * HEIGHT,), 3.4028234663852886e38, device=device)
    for name, (px, py) in orders.items():
        px, py = torch.from_numpy(px).to(device), torch.from_numpy(py).to(device)
        o, d = cs.primary_rays(scene, WIDTH, HEIGHT, px, py)
        out[f"k1_{name}"] = reading(lambda: traverse(tables.trace, o, d, far))
        for shadows in (False, True):
            key = f"k2_{name}_{'shadows' if shadows else 'no_shadows'}"
            out[key] = reading(lambda: render_primary(tables, px, py, WIDTH, HEIGHT,
                                                      shadows=shadows))
        out[f"k3_{name}"] = reading(lambda: render_deferred(ttables, px, py, WIDTH, HEIGHT))

    pt = PathTracer(scene, PT_SIZE, PT_SIZE, device=device)
    for _ in range(3):
        pt.step()
    out["pt_ms_per_spp"] = reading(pt.step)
    prof = [cs.device_profile(pt.step, PT_STEPS, device) for _ in range(REPEATS)]
    out["k6_device_ms_per_spp"] = [p["k6_device_ms"] for p in prof]
    out["pt_device_ms_per_spp"] = [p["device_ms"] for p in prof]
    out["pt_host_enqueue_ms"] = [p["host_enqueue_ms"] for p in prof]
    out["pt_device_ms_by_kind"] = prof[-1]["device_ms_by_kind"]
    return out


def sass_loops(root: str) -> dict:
    """Static SASS size of K1's closest-hit instance for a 32-entry stack,
    from `cuobjdump -sass` of the built traverse object: its instruction
    count, opcode histogram and loops (every backward branch: first and last
    address and the instructions between), a yardstick for how many
    instruction slots a node visit and a triangle test take."""
    import glob
    import re

    sys.path.insert(0, root)
    from gpu_raytracer_tpu_torch.ops.cuda import build

    k = build.load_kernels()
    objs = glob.glob(os.path.join(os.path.dirname(k.path), "*traverse.o"))
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", objs[0]], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s+Function :|\Z)", text, re.S):
        if "traverse_kernelILi32ELb0" not in name:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)([^;]*);", body)
        addr = [int(a, 16) for a, _, _ in ins]
        hist = {}
        for _, op, _ in ins:
            hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
        loops = []
        for a, op, rest in ins:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) < int(a, 16):
                lo, hi = int(m.group(1), 16), int(a, 16)
                loops.append(dict(first=lo, last=hi,
                                  instructions=sum(1 for x in addr if lo <= x <= hi)))
        out = dict(function=name, instructions=len(ins), loops=loops,
                   opcodes=dict(sorted(hist.items(), key=lambda kv: -kv[1])[:16]))
    return out


def run_one(root: str, defines: str, label: str, out: str | None) -> dict:
    """One measurement in its own process -> its JSON line, also printed
    (and appended to `out`)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--one", "--root", root,
           "--defines", defines, "--label", label]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        print(f"[{label}] failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-6000:]}", flush=True)
        return dict(label=label, failed=True)
    print(lines[-1], flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(lines[-1] + "\n")
    return json.loads(lines[-1])


def summary(rows: list[dict]) -> None:
    keys = []
    for r in rows:   # an older tree has no warp-order readings
        keys += [k for k in r if k not in keys and k.startswith(
            ("k1_", "k2_", "k3_", "pt_ms", "k6_device", "pt_device_ms_per", "pt_host"))]
    for k in keys:
        cells = [f"{r['label']}={statistics.median(r[k]):.4f}" for r in rows
                 if not r.get("failed") and k in r]
        print(f"{k}: " + "  ".join(cells), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--one", action="store_true", help="measure one tree, print one JSON line")
    ap.add_argument("--root", default=HERE, help="the tree whose package is measured")
    ap.add_argument("--defines", default="", help="-D settings, space separated (NAME=VALUE)")
    ap.add_argument("--label", default="change")
    ap.add_argument("--parent", help="another tree: run parent, change, change, parent")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="settings to build this tree with, one measurement each, between "
                         "two measurements of the tree as it is")
    ap.add_argument("--out", help="a file to append every measurement's JSON line to")
    ap.add_argument("--sass", action="store_true",
                    help="print the static SASS size of K1's closest-hit instance")
    args = ap.parse_args()
    if args.sass:
        print(json.dumps(dict(sass=sass_loops(os.path.abspath(args.root)))), flush=True)
        return 0
    if args.one:
        print(json.dumps(measure(os.path.abspath(args.root), args.defines.split(), args.label)),
              flush=True)
        return 0
    rows = []
    if args.parent:
        parent = os.path.abspath(args.parent)
        for label, root in (("parent_a", parent), ("change_a", HERE), ("change_b", HERE),
                            ("parent_b", parent)):
            rows.append(run_one(root, "", label, args.out))
    if args.variants:
        rows.append(run_one(HERE, "", "default_a", args.out))
        for v in args.variants:
            rows.append(run_one(HERE, v, v.replace("RT_", "").replace(" ", ","), args.out))
        rows.append(run_one(HERE, "", "default_b", args.out))
    good = [r for r in rows if not r.get("failed")]
    if good:
        summary(good)
    return 0 if len(good) == len(rows) and rows else 1


if __name__ == "__main__":
    sys.exit(main())
