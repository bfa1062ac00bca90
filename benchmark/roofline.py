"""The least time a kernel could take on the card, from the work counted on
the cell's own inputs by the benchmark's walk (reference.py, bvh.py), never
from the program's own counters: the larger of its bytes over the memory
rate and its FP32 operations over the FP32 rate, at the published peaks of
one NVIDIA H100 SXM (the card's power limit is printed beside every run).

Operation counts per unit of work (the arithmetic of chip_smoke.py, counted
from the kernels' sources): a child box test 25 (each live slot of a visited
node of the configuration's width), a Möller-Trumbore test 54, per hit and
light the shading 120, per continued path the sampling 150, a bilinear map
sample 60. Bytes: each input byte read once and each output
byte written once: the frame's pixel coordinates and colours, the pool
fields a bounce reads and writes, and the scene's tables once per launch.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12      # H100 SXM FP32, outside the tensor cores
SLAB_FLOPS = 25
TRI_FLOPS = 54
SHADE_FLOPS = 120
SAMPLE_FLOPS = 150
TEXEL_FLOPS = 60
POOL_READ_BYTES = 45          # origin, direction, throughput, medium, channel, active
POOL_WRITE_BYTES = 52         # a continuation written over its lane
RADIANCE_BYTES = 24           # read and written
ORDER_BYTES = 4               # the coherence order's entry
MATERIAL_BYTES = 28           # albedo, packed scalars, type, base-colour map slot
LIGHT_BYTES = 40


def least_ms(bytes_moved: float, flops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3


def walk_flops(work: dict) -> float:
    """A walk's operations: one box test a live child slot of an inner node
    visited, one test a triangle tested."""
    return work["slots"] * SLAB_FLOPS + work["tests"] * TRI_FLOPS


def scene_bytes(tables: dict) -> float:
    return (tables["tree_bytes"] + tables["materials"] * MATERIAL_BYTES
            + tables["lights"] * LIGHT_BYTES)


def whitted_frame(work: dict, tables: dict, pixels: int, lights: int) -> dict:
    """One Whitted frame (K2): pixel coordinates read (8 bytes) and the
    colour written (12); the walks of its camera and shadow rays; the
    shading of each hit for each light."""
    bytes_moved = pixels * (8 + 12) + scene_bytes(tables)
    flops = walk_flops(work) + work["hits"] * lights * SHADE_FLOPS
    return {"bytes": bytes_moved, "flops": flops, "least_ms": least_ms(bytes_moved, flops)}


def textured_frame(work: dict, tables: dict, pixels: int, lights: int) -> dict:
    """One textured frame (K3's pre-pass, K3, K4): K3 reads the pixel
    coordinates and writes a 32-byte G-buffer entry, K4 reads it and writes
    the colour; the walks, each hit's light sum and material step, one
    base-colour sample (four bilinear taps at two levels at most: counted
    as one sample) a textured hit; the maps' texels once."""
    bytes_moved = (pixels * (8 + 32 + 32 + 12) + scene_bytes(tables)
                   + tables.get("texel_bytes", 0))
    flops = (walk_flops(work) + work["hits"] * lights * SHADE_FLOPS
             + work["hits"] * SHADE_FLOPS + work.get("texel_hits", 0) * TEXEL_FLOPS)
    return {"bytes": bytes_moved, "flops": flops, "least_ms": least_ms(bytes_moved, flops)}


def path_step(work: dict, tables: dict, paths: int, launches: int) -> dict:
    """One path-tracer step (the K6 launches of every depth): each lane
    worked on reads its pool fields, its order entry and its radiance and
    writes the radiance; a continued lane has its continuation written, a
    retired one its flag; the tables once per launch. Operations: the
    closest-hit and shadow walks, per hit the shading and per continued
    lane the sampling."""
    rays = work["rays"]
    continued = max(rays - paths, 0)
    bytes_moved = (rays * (POOL_READ_BYTES + RADIANCE_BYTES + ORDER_BYTES)
                   + continued * POOL_WRITE_BYTES + paths + launches * scene_bytes(tables))
    flops = (walk_flops(work) + work["hits"] * SHADE_FLOPS + continued * SAMPLE_FLOPS
             + work.get("texel_hits", 0) * TEXEL_FLOPS)
    return {"bytes": bytes_moved, "flops": flops, "least_ms": least_ms(bytes_moved, flops)}


# the fly frame's filter: a 5 x 5 tap's operations (the normal weight's dot
# product and 6 squarings, the depth and luminance terms, their exponential,
# the weights' product and the weighted sums)
TAP_FLOPS = 30
GBUFFER_BYTES = 28            # normal, depth, albedo
FIELD_BYTES = 36              # a pass's packed field: colour, normal, depth, luminance, hit


def fly_frame(primary: dict, paths: dict, tables: dict, pixels: int, interleave: int,
              launches: int, passes: int) -> dict:
    """One moving path-traced frame (PathTracer.fly_frame), the sum of three
    stages' least times:
      * the warp: the primary walk of every pixel (`primary`), the pixel
        coordinates read, the G-buffer written, the history (mean, weight,
        old depth) read and the new one written;
      * the coset step: `paths` (the reference's path work scaled to the
        coset's pixels / interleave paths), as path_step;
      * the filter: each pass reads the packed field once and writes the
        colour; the demodulation and remodulation read colour and albedo
        and write colour; 25 taps a pixel and pass."""
    warp_bytes = pixels * (8 + GBUFFER_BYTES + 20 + 16) + scene_bytes(tables)
    warp = least_ms(warp_bytes, walk_flops(primary))
    coset = path_step(paths, tables, pixels // interleave, launches)["least_ms"]
    filter_bytes = pixels * (passes * (FIELD_BYTES + 12) + 2 * (12 + 12 + 12))
    filt = least_ms(filter_bytes, pixels * passes * 25 * TAP_FLOPS)
    return {"warp_ms": warp, "coset_ms": coset, "filter_ms": filt,
            "least_ms": warp + coset + filt}
