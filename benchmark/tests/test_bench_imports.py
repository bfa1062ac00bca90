"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole, so the port's own name passes), and a reference that loads
nothing of the program."""

import json
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_raytracer_tpu")


def _modules(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_metrics_load_no_jax():
    code = ("import json, os\n"
            "from benchmark import run, control, checks\n"
            "m = run.load_json(run.ROOT, 'BENCHMARK.json')\n"
            "for w in m['workloads']:\n"
            "    mix = run.load_json(run.BENCH, 'traffic', w['traffic'] + '.json')\n"
            "    run.load_module('drivers', mix['driver'])\n"
            "for x in m['per_layer']:\n"
            "    run.load_module('metrics', x['name'])\n"
            "import gpu_raytracer_tpu_torch.engine.viewer, gpu_raytracer_tpu_torch.engine.pathtracer\n")
    mods = _modules(code)
    assert "gpu_raytracer_tpu_torch" in mods     # the port's name is not the JAX package's
    assert not mods & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _modules("from benchmark import reference, bvh, scenes, generator, roofline, checks")
    assert "gpu_raytracer_tpu_torch" not in mods and not mods & set(FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    from benchmark import run

    saved = dict(sys.modules)
    try:
        sys.modules["gpu_raytracer_tpu_torch_fake"] = sys
        sys.modules["jaxfake"] = sys
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & set(FORBIDDEN))
        sys.modules["jax.numpy"] = sys
        assert "jax" in run.forbidden_modules()
    finally:
        for k in ("gpu_raytracer_tpu_torch_fake", "jaxfake", "jax.numpy"):
            sys.modules.pop(k, None)
