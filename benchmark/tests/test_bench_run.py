"""A run end to end on the CPU at a tiny size (the harness's look for a card
skipped): the result line's keys and the check. And a run as the driver
starts it: without a card it exits non-zero and prints no result."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark import run

from .conftest import ROOT, TINY_SECONDS, tiny_cell

# the cells of BENCHMARK.json, and the present mix the benchmark keeps for
# a later cell (PERF.md, Open questions)
CELLS = ["courtyard-100k.orbit-1080p", "courtyard-100k.progressive-1024",
         "courtyard-100k-tex.orbit-1080p", "courtyard-100k-tex.present-1080p",
         "courtyard-100k.fly-1024"]


def run_tiny(workload, trace, capsys, seed=2 ** 31 + 99, patch=None):
    manifest, cell, config, mix = tiny_cell(workload)
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=TINY_SECONDS[mix["driver"]],
                                 trace=trace)
    rc = run.run_cell(args, manifest, cell, config, mix, torch.device("cpu"))
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line_and_check(workload, trace, capsys):
    rc, line, err = run_tiny(workload, trace, capsys)
    assert rc == 0
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    # the compared numbers, each beside its limit, close standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and "(limit " in t for t in tail)
    manifest = run.load_json(ROOT, "BENCHMARK.json")
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in run.cell_metrics(manifest, section, workload)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert "setup_s" in line["metrics"]
    else:
        if workload in {w["name"] for w in manifest["workloads"]}:
            assert "scene_build_s" in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["platform"] == "cpu"   # a CPU run never names a card


def test_no_card_no_result(tmp_path):
    """As the driver starts it, on a machine without a CUDA device: a
    non-zero exit and no JSON line, with no fallback to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                        "5", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder:
    a non-zero exit and no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[1], "--seed",
                        "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout
