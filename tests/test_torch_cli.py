"""`python -m gpu_raytracer_tpu_torch render` writes a PNG of the frame."""

import os
import struct
import subprocess
import sys

import pytest

import torch_bridge  # noqa: F401  (thread cap)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "gpu_raytracer_tpu_torch", "render", *args],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)


@pytest.mark.parametrize("scene_args", [["--courtyard", "2000", "--shadows"], ["--demo"],
                                        ["--courtyard", "2000", "--textured"]])
def test_render_writes_a_png(tmp_path, scene_args):
    out = tmp_path / "frame.png"
    proc = _run([*scene_args, "--width", "64", "--height", "48", "--device", "cpu",
                 "-o", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    width, height = struct.unpack(">II", data[16:24])
    assert (width, height) == (64, 48)
    assert "wrote" in proc.stdout


def test_render_refuses_unported_scenes(tmp_path):
    proc = _run(["--gltf", "scene.glb", "--device", "cpu", "-o", "x.png"], tmp_path)
    assert proc.returncode != 0 and "NotImplementedError" in proc.stderr
