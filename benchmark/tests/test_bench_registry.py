"""BENCHMARK.json against the contract's shape, and the harness finding
configurations, mixes, drivers and metrics by name only."""

import json
import os
import re

import pytest

from benchmark import run

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_has_exactly_the_contract_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for word in manifest["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


def test_names_units_and_lines(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]
        names += [w["name"], w["traffic"]]
    for section in ("end_to_end", "per_layer"):
        for m in manifest[section]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert {"frame_ms", "frame_p95_ms", "step_ms", "setup_s"} <= e2e
    assert all(m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in manifest["end_to_end"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:   # each listed cell reports the metric it moves
            assert w in next(x for x in manifest["end_to_end"]
                             if x["name"] == m["moves"]).get("workloads", [w])


@pytest.mark.parametrize("section", ["configs", "traffic", "drivers", "metrics"])
def test_every_entry_resolves_to_its_file(manifest, section):
    if section == "configs":
        for c in manifest["configs"]:
            assert run.load_json(run.BENCH, "configs", c["name"] + ".json")["scene"]
    elif section == "traffic":
        for w in manifest["workloads"]:
            mix = run.load_json(run.BENCH, "traffic", w["traffic"] + ".json")
            assert os.path.exists(os.path.join(run.BENCH, "drivers", mix["driver"] + ".py"))
    elif section == "drivers":
        kinds = {run.load_json(run.BENCH, "traffic", w["traffic"] + ".json")["driver"]
                 for w in manifest["workloads"]}
        for kind in kinds:
            assert hasattr(run.load_module("drivers", kind), "Driver")
    else:
        for m in manifest["per_layer"]:
            assert callable(run.load_module("metrics", m["name"]).read)


def test_a_new_mix_and_metric_are_found_by_name_alone():
    """A mix and a per-layer metric added as files only: the harness finds
    them by the names an entry would give, with no file edited."""
    mix_path = os.path.join(run.BENCH, "traffic", f"_throwaway_{os.getpid()}.json")
    met_path = os.path.join(run.BENCH, "metrics", f"_throwaway_{os.getpid()}.py")
    manifest = {"workloads": [{"name": "courtyard-100k.throwaway", "config": "courtyard-100k",
                               "traffic": f"_throwaway_{os.getpid()}", "chips": 1}],
                "per_layer": [{"name": f"_throwaway_{os.getpid()}",
                               "workloads": ["courtyard-100k.throwaway"]}]}
    try:
        with open(mix_path, "w") as f:
            json.dump({"driver": "viewer", "present": True}, f)
        with open(met_path, "w") as f:
            f.write("def read(t):\n    return 42.0\n")
        cell = run.find_cell(manifest, "courtyard-100k.throwaway")
        mix = run.load_json(run.BENCH, "traffic", cell["traffic"] + ".json")
        assert run.load_module("drivers", mix["driver"]).Driver.unit == "frame"
        metrics = run.cell_metrics(manifest, "per_layer", cell["name"])
        assert [run.load_module("metrics", m["name"]).read(None) for m in metrics] == [42.0]
    finally:
        os.remove(mix_path)
        os.remove(met_path)
