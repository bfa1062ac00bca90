"""`python -m gpu_raytracer_tpu_torch render` and `pathtrace` write a PNG of
the frame."""

import os
import struct
import subprocess
import sys

import pytest

import torch_bridge  # noqa: F401  (thread cap)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path, command="render"):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "gpu_raytracer_tpu_torch", command, *args],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)


def _png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", data[16:24])


@pytest.mark.parametrize("scene_args", [["--courtyard", "2000", "--shadows"], ["--demo"],
                                        ["--courtyard", "2000", "--textured"]])
def test_render_writes_a_png(tmp_path, scene_args):
    out = tmp_path / "frame.png"
    proc = _run([*scene_args, "--width", "64", "--height", "48", "--device", "cpu",
                 "-o", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _png_size(out) == (64, 48)
    assert "wrote" in proc.stdout


def test_pathtrace_writes_a_png_and_resumes(tmp_path):
    out, ckpt = tmp_path / "pt.png", tmp_path / "pt.npz"
    args = ["--courtyard", "500", "--width", "16", "--height", "12", "--spp", "2", "--spectral",
            "--device", "cpu", "--checkpoint", str(ckpt), "-o", str(out)]
    proc = _run(args, tmp_path, "pathtrace")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _png_size(out) == (16, 12)
    assert "(2 spp)" in proc.stdout and ckpt.exists()
    proc = _run([*args, "--resume", str(ckpt)], tmp_path, "pathtrace")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "resumed at 2 spp" in proc.stdout and "(4 spp)" in proc.stdout


def test_render_refuses_unported_scenes(tmp_path):
    proc = _run(["--gltf", "scene.glb", "--device", "cpu", "-o", "x.png"], tmp_path)
    assert proc.returncode != 0 and "NotImplementedError" in proc.stderr


@pytest.mark.parametrize("flags", [["--adaptive", "4"], ["--denoise"]])
def test_pathtrace_refuses_unported_options(tmp_path, flags):
    proc = _run([*flags, "--width", "8", "--height", "8", "--device", "cpu", "-o", "x.png"],
                tmp_path, "pathtrace")
    assert proc.returncode != 0 and "NotImplementedError" in proc.stderr
