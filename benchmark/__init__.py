"""The benchmark of gpu_raytracer_tpu_torch: run.py runs one cell once."""
