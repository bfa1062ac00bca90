"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python -m benchmark.run ... (the same)

The cell is an entry of `workloads` in BENCHMARK.json; its configuration is
benchmark/configs/<config>.json, its traffic mix benchmark/traffic/<mix>.json,
which names a driver kind, benchmark/drivers/<kind>.py. The driver kind owns
its loop, its check against the plain reference (`check`), the least times
of its rooflines (`least_ms`) and its lower-precision control (`control`).
Per-layer metrics are benchmark/metrics/<name>.py, each a `read(trace)`
found by its name. Nothing here names a cell, a mix, a metric, a driver kind
or a unit: adding any of them adds files and entries only.

A run: set-up (the program's scene, its Viewer or PathTracer, the warm-up of
the cell's own shapes; `setup_s` runs from the process's start to the first
timed frame or step), the measured window of `--seconds`, then with
`--trace 1` a profiled burst of the same loop, then the check against the
plain reference once the program's state is freed. The last line of standard
output is one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error and the last key of that object.

It needs a CUDA device (none: exit 2, no result) and the program's package
beside it (none: exit 3), and it refuses to print a result when the process
holds JAX or the JAX package (exit 4).
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__" and __package__ in (None, ""):
    # run as a script: import the benchmark as a package from the checkout
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, ROOT)

import argparse            # noqa: E402
import gc                  # noqa: E402
import importlib.util      # noqa: E402
import json                # noqa: E402
import subprocess          # noqa: E402
import tempfile            # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_raytracer_tpu")
BENCH = os.path.join(ROOT, "benchmark")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module of its own, found by name."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def find_cell(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(manifest: dict, section: str, workload: str) -> list:
    return [m for m in manifest[section] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def set_caches() -> None:
    """Every cache of the program inside the checkout, at fixed paths: nvcc's
    output goes to the program's build/cuda/<hash>/ there already; Triton's
    cache to build/triton. The atlas's disk cache is off, so that every run
    builds the same atlas from the seed."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["GPU_RAYTRACER_TPU_TORCH_CACHE"] = ""


def profile_burst(driver, count: int) -> dict:
    """`count` more frames or steps of the window's loop under torch.profiler
    -> the device's kernels and copies, the host's labelled spans and the
    burst's own span, read from the exported trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if driver.cuda else [])
    with profile(activities=acts) as prof:
        with record_function("burst"):
            driver.label = record_function
            driver.run(count=count)
            driver.label = None
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    dev, notes, burst = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((e["name"], float(e["ts"]), float(e["dur"]), cat))
        elif cat == "user_annotation":
            if e["name"] == "burst":
                burst = (float(e["ts"]), float(e["dur"]))
            else:
                notes.append((e["name"], float(e["ts"]), float(e["dur"])))
    if burst is None:
        raise RuntimeError("the profiler's trace holds no burst span")
    lo, hi = burst[0], burst[0] + burst[1]
    end = max([hi] + [ts + du for _, ts, du, _ in dev])
    dev = [x for x in dev if x[1] + x[2] > lo and x[1] < end]
    return dict(device=sorted(dev, key=lambda x: x[1]), notes=notes, start_us=lo,
                end_us=end, iterations=count)


class Trace:
    """What a per-layer metric reads: the unit of the cell's loop ("frame"
    or "step"), the window's host spans (name -> seconds), the profiled
    burst, the least times in ms a frame or step by kernel group that the
    reference's work gives (`work`), the set-up's parts, and whether the
    loop presents its frames."""

    def __init__(self, unit, spans, burst, work, setup, present):
        self.unit, self.spans, self.burst = unit, spans, burst
        self.work, self.setup, self.present = work, setup, present

    def busy_us(self) -> float:
        """Time in the burst with a kernel or a copy on the card (the union
        of their intervals)."""
        busy, cur_s, cur_e = 0.0, None, None
        for _, ts, du, _ in self.burst["device"]:
            s, e = max(ts, self.burst["start_us"]), min(ts + du, self.burst["end_us"])
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                busy += 0.0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        return busy + (0.0 if cur_e is None else cur_e - cur_s)

    def window_us(self) -> float:
        return self.burst["end_us"] - self.burst["start_us"]

    def kernel_us(self, *words) -> tuple[float, int]:
        """(total device us, launches) of the kernels whose names hold any of `words`."""
        hits = [du for name, _, du, cat in self.burst["device"]
                if cat == "kernel" and any(w in name for w in words)]
        return sum(hits), len(hits)


def short(name: str) -> str:
    name = name.replace("void ", "")
    return name.split("(")[0].split("<")[0][:96] or name[:96]


def breakdown(tr: Trace) -> dict:
    ops = {}
    for name, _, du, _ in tr.burst["device"]:
        ops[short(name)] = ops.get(short(name), 0.0) + du / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    prev_end = tr.burst["start_us"]
    for _, ts, du, _ in tr.burst["device"] + [("", tr.burst["end_us"], 0.0, "")]:
        if ts > prev_end:
            gaps.append((prev_end, ts - prev_end))
        prev_end = max(prev_end, ts + du)
    gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    named = []
    for start, length in gaps:
        open_spans = [(ts, n) for n, ts, du in tr.burst["notes"] if ts <= start < ts + du]
        named.append([max(open_spans)[1] if open_spans else "outside any span", length / 1e6])
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": named}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    manifest = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(manifest, args.workload)
    config = load_json(BENCH, "configs", cell["config"] + ".json")
    mix = load_json(BENCH, "traffic", cell["traffic"] + ".json")
    set_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available: "
              "no result", file=sys.stderr)
        return 2
    if importlib.util.find_spec("gpu_raytracer_tpu_torch") is None:
        print("the program (gpu_raytracer_tpu_torch) is not in this checkout: no result",
              file=sys.stderr)
        return 3
    return run_cell(args, manifest, cell, config, mix, torch.device("cuda", 0))


def run_cell(args, manifest, cell, config, mix, device) -> int:
    import torch

    from benchmark import checks
    from benchmark.drivers.common import Spans

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spans = Spans(on=bool(args.trace))
    driver = load_module("drivers", mix["driver"]).Driver(config, mix, args.seed, device, spans)
    setup = driver.setup()
    # what set-up left behind is kept out of the collector's scans: the
    # window's collections cost what the window's own objects cost
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_PROCESS
    e2e = driver.run(seconds=args.seconds)
    gc.unfreeze()
    window = dict(driver.window)
    mem_peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    spans.on = False
    burst = profile_burst(driver, mix["trace_count"]) if args.trace else None

    # the check, once the program's state is freed
    t_check = time.perf_counter()
    outputs = driver.outputs()
    free(driver, device)
    nums, work, compared, tree_bytes = driver.check(outputs, device)
    check_s = time.perf_counter() - t_check
    correct, rows = checks.judge(nums, mix["limits"])

    bad = forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}: no result", file=sys.stderr)
        return 4

    least = driver.least_ms(work, tree_bytes)
    result_metrics = {}
    if args.trace:
        tr = Trace(driver.unit, spans.times, burst, least, setup,
                   bool(getattr(driver, "present", False)))
        for m in cell_metrics(manifest, "per_layer", args.workload):
            v = load_module("metrics", m["name"]).read(tr)
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in cell_metrics(manifest, "end_to_end", args.workload):
            if m["name"] in values:
                result_metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(mem_peak),
           "power_limit_w": power_limit_w() if cuda else None}
    out = {"correct": bool(correct), "attempted": int(e2e["attempted"]),
           "failed": int(e2e["failed"]), "metrics": result_metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = tr.busy_us() / 1e6
        dev["window_s"] = tr.window_us() / 1e6
        out["breakdown"] = breakdown(tr)
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    print("run " + json.dumps({"setup_s": setup_s, **{k: float(v) for k, v in setup.items()},
                               "window": window, "compared": compared, "check_s": check_s,
                               "least_ms": least},
                              default=_jsonable), file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(out, default=_jsonable))
    return 0


def free(driver, device) -> None:
    """Drop the program's state and give its memory back before the
    reference runs."""
    import torch

    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _jsonable(x):
    if hasattr(x, "item"):
        return x.item()
    raise TypeError(type(x))


if __name__ == "__main__":
    sys.exit(main())
