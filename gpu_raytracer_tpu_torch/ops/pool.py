"""The path tracer's loop over the depths: a ray pool traced to termination.

`path_trace_pool` drives the bounce kernel's wrapper
(ops/cuda/bounce.py::fused_bounce_) from a static loop over the depths, the
same way on either device: a CUDA pool launches the kernel, a CPU pool
takes its plain version (ops/wavefront.py::bounce_). Between depths the
live lanes are put in coherence order (ops/wavefront.py::coherence_order).
No step of the loop reads a value back to the host.
"""

from __future__ import annotations

import torch

from ..engine.perf import count, span
from ..models.scene import Scene
from .cuda.bounce import fused_bounce_
from .sampler import QmcStream
from .wavefront import WavefrontRays, coherence_order, stream_uniforms


def bounce_flags(scene: Scene, depth: int, max_depth: int = 4, rr_start: int = 2,
                 shadows: bool = True, tex_lod_bias: float = 0.0) -> dict:
    """The bounce arguments of `depth` in a loop to `max_depth`: Russian
    roulette on the continuations entering depth >= rr_start, single-light
    NEE with shadows and several lights, the textures at level
    tex_lod_bias * depth, and `last` at max_depth."""
    return dict(shadows=shadows, do_rr=max_depth >= rr_start and depth + 1 >= rr_start,
                light_sample=shadows and scene.lights.count > 1,
                tex_lod=tex_lod_bias * depth, last=depth == max_depth)


def path_trace_pool(tables, rays: WavefrontRays, max_depth: int = 4, rr_start: int = 2,
                    shadows: bool = True, qmc: bool = False, qmc_pid_base=0, sample_base=0,
                    qmc_seed=0, qmc_spp: int = 1, tex_lod_bias: float = 0.0,
                    rng_seed: int = 0):
    """Trace a pool to termination -> (radiance [N,3] in the pool's lane
    order, per-depth active counts [max_depth + 1] int64, on the device).
    The pool `rays` is consumed: its tensors are updated in place.

    `tables` are the bounce tables of the scene (ops/cuda/bounce.py
    `pack_bounce_tables`): a CUDA pool runs the bounce kernel, a CPU pool its
    plain version, through the same calls. Depth d: count the live lanes,
    order them for coherence (not at depth 0: camera rays arrive in
    tile-major order), then one `fused_bounce_` over the first `count`
    positions of the order, with Russian roulette
    when the continuation enters depth >= rr_start, the textures at level
    tex_lod_bias * d and `last` at max_depth. With `qmc` the uniforms follow
    each lane's identity (the kernel computes them); otherwise they are an
    independent stream drawn by position in the order."""
    scene = tables.scene
    N = rays.count
    dev = rays.origin.device
    r = rays
    radiance = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    stream = QmcStream(int(qmc_pid_base), int(sample_base), int(qmc_seed), qmc_spp) if qmc else None
    order = None
    counts = []
    for depth in range(max_depth + 1):
        n_live = r.active.sum()
        counts.append(n_live)
        if depth > 0:
            with span("pool.order"):
                order = coherence_order(scene, r, order)
        u = None if qmc else stream_uniforms(rng_seed, sample_base, depth, N, dev)
        with span("pool.bounce"):
            # the bounce's attempts and its useful work: lanes handed over, live lanes
            count("pool.lanes", N)
            count("pool.live", n_live)
            # only an order puts the live lanes first
            fused_bounce_(tables, r, radiance, depth=depth, order=order,
                          n_live=None if order is None else n_live, u=u, qmc=stream,
                          **bounce_flags(scene, depth, max_depth, rr_start, shadows,
                                         tex_lod_bias))
    return radiance, torch.stack(counts)
