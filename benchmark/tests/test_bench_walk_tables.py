"""`walk_tables_mb.frame`, read from the program's counter on synthetic
bursts: the counted bytes over the frame kernels' launches in the burst,
and nothing where the program counted nothing, where no frame kernel ran,
or in a cell of steps."""

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import run

K2 = "void rt::render_primary_kernel<4, 64, true>(rt::Node<4> const*, float4 const*)"
COPY = "Memcpy HtoD (Pageable -> Device)"


def burst(unit, device, iterations=4):
    b = dict(device=device, notes=[], start_us=0.0, end_us=1e6, iterations=iterations)
    return run.Trace(unit, {}, b, {}, {}, False)


@pytest.fixture
def read():
    from gpu_raytracer_tpu_torch.engine import perf

    perf.reset()
    yield run.load_module("metrics", "walk_tables_mb.frame").read
    perf.reset()


def test_counted_bytes_over_the_frame_kernels_launches(read):
    from gpu_raytracer_tpu_torch.engine import perf

    k2 = [(K2, 10.0 + 500.0 * i, 300.0, "kernel") for i in range(4)]
    copy = [(COPY, 5.0, 1.0, "gpu_memcpy")]
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in k2:
            perf.count("render.table_bytes", 60_311_808)
    assert read(burst("frame", k2 + copy)) == pytest.approx(60.311808)
    assert read(burst("frame", copy)) is None        # no frame kernel in the burst
    assert read(burst("step", k2)) is None


def test_nothing_counted_reads_none(read):
    k2 = [(K2, 10.0, 300.0, "kernel")]
    assert read(burst("frame", k2)) is None
