"""Wavefront path tracing.

The ray pool is a dataclass of per-lane tensors. One bounce traces every
live lane to its closest hit, adds sky x throughput on a miss or direct
lighting x throughput on a hit (single-light next-event estimation when the
scene has several lights and shadows are on), and samples the continuation
in place: a cosine lobe, a mirror lobe widened by roughness, or Fresnel
glass with the wavelength-dependent IOR. Russian roulette then retires
lanes of low throughput.

Spectral mode: a ray carries full RGB throughput (channel RGB_CHANNEL) and
collapses to one wavelength only at its first transmissive hit, with a 3x
one-hot throughput, so the estimator stays unbiased and only paths through
glass pay for dispersion.

`bounce` is the plain version of the bounce kernel in its functional form
(pool in, new pool and radiance out); `bounce_` is the plain version of
the kernel's own contract (ops/cuda/bounce.py::fused_bounce_): the pool and
the radiance updated in place, only the live lanes of a coherence order
worked on. `coherence_order` orders the live lanes between depths by
(direction octant | dominant axis | coarse origin Morton code) for
traversal coherence, dead lanes last; the pool itself never moves, the
kernel goes to its lanes through the order. The loop over the depths is
ops/pool.py::path_trace_pool.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from ..models.scene import Scene
from .camera_rays import generate_rays
from .intersect import MISS_T
from .linalg import dot, normalize
from .rng import bounce_key, sample_uniform
from .sampler import qmc_uniforms
from .sampling import (RAY_CAMERA, RAY_REFLECT, RAY_TRANSMIT, cosine_hemisphere,
                       ior_for_channel, reflect, refract, schlick_fresnel)
from .shading import (MAGENTA, MaterialSample, _brdf_scale, apply_dispersion, direct_lighting,
                      dispersion_blend, light_intensity, lit_by_all_lights, sample_light_index,
                      sample_materials)
from .trace import Hit, occluded, trace

SKY_WAVEFRONT = (0.1, 0.2, 0.3)
# The wavelength-channel sentinel of a ray that still carries full RGB.
RGB_CHANNEL = 3
_LIVE_LIMIT = MISS_T - 2.0   # f32::MAX - 2, which rounds to f32::MAX


class WavefrontCounters:
    """Per-bounce-depth ray accounting of the last step, filled with the
    pool's real active counts."""

    MAX_DEPTHS = 8

    def __init__(self, max_bounce_depth: int, frame_seed: int = 0):
        self.total_rays_generated = 0
        self.rays_per_bounce = [0] * self.MAX_DEPTHS
        self.active_bounce_depths = 0
        self.max_bounce_depth = max_bounce_depth
        self.frame_seed = frame_seed

    def reset(self, frame_seed: int) -> None:
        self.total_rays_generated = 0
        self.rays_per_bounce = [0] * self.MAX_DEPTHS
        self.active_bounce_depths = 0
        self.frame_seed = frame_seed

    def add_rays(self, bounce_depth: int, count: int) -> None:
        if bounce_depth < self.MAX_DEPTHS:
            self.rays_per_bounce[bounce_depth] += count
            self.total_rays_generated += count
            self.active_bounce_depths |= 1 << bounce_depth

    def get_ray_count(self, bounce_depth: int) -> int:
        if bounce_depth < self.MAX_DEPTHS:
            return self.rays_per_bounce[bounce_depth]
        return 0

    def has_active_rays(self, bounce_depth: int) -> bool:
        if bounce_depth < self.MAX_DEPTHS:
            return bool(self.active_bounce_depths & (1 << bounce_depth))
        return False

    def next_active_bounce_depth(self, current_depth: int):
        for depth in range(current_depth + 1, min(self.max_bounce_depth, 7) + 1):
            if self.has_active_rays(depth):
                return depth
        return None

    def has_any_active_rays(self) -> bool:
        return self.active_bounce_depths != 0 and self.total_rays_generated > 0


@dataclass
class WavefrontRays:
    """Fixed-capacity ray pool, one lane per ray."""

    origin: torch.Tensor              # [N,3] f32
    direction: torch.Tensor           # [N,3] f32
    ray_type: torch.Tensor            # [N] i32 (0 camera, 1 reflect, 2 transmit, 3 shadow)
    bounce_depth: torch.Tensor        # [N] i32
    throughput: torch.Tensor          # [N,3] f32
    medium_ior: torch.Tensor          # [N] f32
    pixel: torch.Tensor               # [N] i32 flat pixel index
    inv_pdf: torch.Tensor             # [N] f32
    t_min: torch.Tensor               # [N] f32
    t_max: torch.Tensor               # [N] f32
    wavelength_channel: torch.Tensor  # [N] i32 (0-2 one wavelength, 3 full RGB)
    active: torch.Tensor              # [N] bool

    @property
    def count(self) -> int:
        return self.origin.shape[0]

    def replace(self, **kw) -> "WavefrontRays":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "WavefrontRays":
        """A copy with its own tensors (the in-place bounce writes a pool)."""
        return WavefrontRays(**{f.name: getattr(self, f.name).clone()
                                for f in dataclasses.fields(self)})


def camera_wavefront_rays(camera, width: int, height: int, px: torch.Tensor,
                          py: torch.Tensor, channel: int, jitter: torch.Tensor | None = None,
                          fov_scale: float | None = None) -> WavefrontRays:
    """Camera rays as a pool: throughput 1, medium IOR 1, t_min 1e-3, active."""
    o, d = generate_rays(camera, width, height, px, py, jitter=jitter, fov_scale=fov_scale)
    n = o.shape[0]
    dev = o.device
    full = lambda v, dtype=torch.float32: torch.full((n,), v, dtype=dtype, device=dev)
    return WavefrontRays(
        origin=o.contiguous(), direction=d.contiguous(),
        ray_type=full(RAY_CAMERA, torch.int32),
        bounce_depth=full(0, torch.int32),
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        medium_ior=full(1.0),
        pixel=(py.to(torch.int32) * width + px.to(torch.int32)),
        inv_pdf=full(1.0), t_min=full(1e-3), t_max=full(3.0e38),
        wavelength_channel=full(int(channel), torch.int32),
        active=torch.ones((n,), dtype=torch.bool, device=dev))


def _shadow_mask_points(scene: Scene, point: torch.Tensor, normal: torch.Tensor,
                        hit_mask: torch.Tensor) -> torch.Tensor:
    """[N,L] light visibility from hit points: shadow rays start 1e-3 off the
    surface along the geometric normal and end 1e-3 short of a point light;
    lanes without a live hit get max_t = 0 rays (rejected at once) and 1."""
    L = scene.lights
    N = point.shape[0]
    to_light = L.position[None, :, :] - point[:, None, :]           # [N,L,3]
    dist = torch.sqrt(dot(to_light, to_light))
    pl_dir = to_light / dist[..., None]
    ldir = normalize(L.direction)[None, :, :].expand_as(to_light)
    is_dir = (L.light_type == 0)[None, :].expand(N, L.count)
    sdir = torch.where(is_dir[..., None], -ldir, pl_dir)
    smax = torch.where(is_dir, torch.full_like(dist, 3.0e38), dist - 1e-3)
    smax = torch.where(hit_mask[:, None], smax, torch.zeros_like(smax))
    # light-major: the rays of one light are consecutive
    o = (point + normal * 1e-3)[None, :, :].expand(L.count, N, 3).reshape(-1, 3)
    blocked = occluded(scene, o, sdir.transpose(0, 1).reshape(-1, 3),
                       smax.transpose(0, 1).reshape(-1))
    mask = 1.0 - blocked.reshape(L.count, N).transpose(0, 1).to(torch.float32)
    return torch.where(hit_mask[:, None], mask, torch.ones_like(mask))


@functools.lru_cache(maxsize=None)
def _key_tables(device: torch.device):
    """Constants of `_sort_key` on `device`, made once: the octant weights
    (4, 2, 1) and, per axis, the 16 cell indices with their 4 bits spread to
    every third bit (x at bit 2, y at bit 1, z at bit 0 of each triple)."""
    cell = torch.arange(16, dtype=torch.int32, device=device)
    spread = torch.zeros_like(cell)
    for b in range(4):
        spread = spread | (((cell >> b) & 1) << (3 * b))
    weights = torch.tensor([4, 2, 1], dtype=torch.int32, device=device)
    return weights, torch.stack([spread << 2, spread << 1, spread])


def _sort_key(scene: Scene, o: torch.Tensor, d: torch.Tensor,
              active: torch.Tensor) -> torch.Tensor:
    """Coherence key of each lane, int32: (direction octant | dominant axis
    | 12-bit origin Morton code in the root box), dead lanes keyed past
    every live one. Few, whole-tensor operations: on the card each one is a
    launch, and a step is bound by the host's launches."""
    weights, spread = _key_tables(o.device)
    octant = ((d >= 0).to(torch.int32) * weights).sum(dim=1, dtype=torch.int32)
    axis = torch.argmax(torch.abs(d), dim=1).to(torch.int32)
    lo = scene.bvh.node_min[0]
    hi = scene.bvh.node_max[0]
    # clamp before truncating: the same cells as truncate-then-clip, and no
    # out-of-range float to int conversion; again after it, so that a NaN
    # origin (whatever integer it becomes) still indexes the tables
    q = torch.clamp((o - lo) / (hi - lo + 1e-6) * 16.0, 0.0, 15.0).long().clamp_(0, 15)
    morton = spread.gather(1, q.t()).sum(dim=0, dtype=torch.int32)   # disjoint bits: sum = or
    key = (((octant << 2) | axis) << 12) | morton
    return torch.where(active, key, torch.full_like(key, 2 ** 30))


def _sort_perm(scene: Scene, o: torch.Tensor, d: torch.Tensor,
               active: torch.Tensor) -> torch.Tensor:
    """Coherence order of a pool: a stable sort by `_sort_key`, so equal
    keys keep their lane order."""
    return torch.sort(_sort_key(scene, o, d, active), stable=True)[1]


def coherence_order(scene: Scene, r: WavefrontRays,
                    previous: torch.Tensor | None = None) -> torch.Tensor:
    """[N] int32, sorted position -> lane: the lanes of the pool in
    coherence order (`_sort_perm`), dead lanes last. Lanes of equal key stay
    in the order of `previous` (the order of the depth before; None: lane
    order), as if the pool had been moved into each order in turn."""
    key = _sort_key(scene, r.origin, r.direction, r.active)
    if previous is None:
        return torch.sort(key, stable=True)[1].to(torch.int32)
    return previous[torch.sort(key[previous.long()], stable=True)[1]]


def pool_uniforms(qmc, depth: int, lane: torch.Tensor, count: int) -> torch.Tensor:
    """The [len(lane),7] QMC uniform block of bounce `depth` for lanes
    `lane` of a `count`-lane pool with identity `qmc` (ops/sampler.py
    QmcStream): lattice uniforms addressed by the ray's identity in the
    chunk-major [spp, C] pool, pixel id pid_base + lane % C and sample index
    sample_base + lane // C, so a lane's numbers do not depend on where a
    coherence order puts it. The plain version of the bounce kernel's own
    stream."""
    C = count // qmc.spp
    lane = lane.to(torch.int64)
    return qmc_uniforms(int(qmc.pid_base) + lane % C, int(qmc.sample_base) + lane // C, depth,
                        qmc.seed)


def stream_uniforms(rng_seed: int, sample_base: int, depth: int, count: int,
                    device) -> torch.Tensor:
    """The [count,7] uniform block of bounce `depth` from the independent
    stream (sampler "rng"), one row per position of the coherence order."""
    return sample_uniform(bounce_key(rng_seed, sample_base, depth, device=device), (count,), 7)


def sampled_shadow_rays(scene: Scene, hit: Hit, live: torch.Tensor, u6: torch.Tensor):
    """The light each lane picks, li = min(int(u6 * L), L - 1), its
    unshadowed intensity and the shadow ray toward it -> (li, I, origin,
    direction, max_t): from p + n * 1e-3 along the geometric normal, ending
    1e-3 short of a point light; max_t 0 (no ray) where the lane is not a
    live hit or the light adds nothing."""
    L = scene.lights
    li = sample_light_index(scene, u6)
    I = light_intensity(scene, hit).gather(1, li[:, None])[:, 0]
    p, n = hit.point, hit.normal
    to_light = L.position[li] - p
    dist = torch.sqrt(dot(to_light, to_light))
    pl_dir = to_light / dist[:, None]
    directional = L.light_type[li] == 0
    sdir = torch.where(directional[:, None], -normalize(L.direction)[li], pl_dir)
    smax = torch.where(directional, torch.full_like(dist, 3.0e38), dist - 1e-3)
    smax = torch.where(live & (I > 0.0), smax, torch.zeros_like(smax))
    return li, I, p + n * 1e-3, sdir, smax


def _direct_lighting_sampled(scene: Scene, hit: Hit, live: torch.Tensor, u6: torch.Tensor,
                             mat: MaterialSample) -> torch.Tensor:
    """Single-light next-event estimation: each lane picks ONE light, traces
    one shadow ray to it, and weights its contribution by the light count,
    an unbiased estimate of the sum over the lights."""
    L = scene.lights
    nL = L.count
    li, I, o, sdir, smax = sampled_shadow_rays(scene, hit, live, u6)
    blocked = occluded(scene, o, sdir, smax)
    I = I * (1.0 - blocked.to(torch.float32))
    brdf = _brdf_scale(mat.metallic)[:, 0]
    gate = (I > 0.0).to(torch.float32)
    per = mat.albedo * (brdf * I * gate * nL)[:, None] * L.color[li]
    ambient = mat.albedo * 0.1
    if mat.occlusion is not None:
        ambient = ambient * mat.occlusion[:, None]
    return ambient + per + mat.emission


def bounce(scene: Scene, r: WavefrontRays, u: torch.Tensor, *, shadows: bool, do_rr: bool,
           light_sample: bool = False, tex_lod: float = 0.0,
           last: bool = False):
    """One wavefront bounce of the pool -> (next pool, radiance [N,3]).

    u [N,7]: diffuse / fuzz x, diffuse / fuzz y, fuzz z, Fresnel, roulette,
    channel split, light pick. `do_rr`: Russian roulette on the
    continuations; `light_sample`: single-light NEE (with shadows and more
    than one light); `tex_lod`: the mip level every texture is sampled at;
    `last`: the final depth, whose continuation is never traced (the pool
    comes back unchanged with every lane retired). The plain version of the
    bounce kernel: a dead lane keeps its state and adds nothing."""
    mats = scene.materials
    dev = r.origin.device
    live = r.active
    limit = torch.where(live, torch.full_like(r.medium_ior, _LIVE_LIMIT),
                        torch.zeros_like(r.medium_ior))
    hit = trace(scene, r.origin, r.direction, max_t=limit)
    hit_live = live & hit.hit
    miss_live = live & ~hit.hit
    thr = r.throughput

    sky = torch.tensor(SKY_WAVEFRONT, dtype=torch.float32, device=dev)
    zero3 = torch.zeros_like(thr)
    radiance = torch.where(miss_live[:, None], sky[None, :] * thr, zero3)

    mid = torch.clamp(hit.material_id, 0, mats.count - 1)
    tex = scene.textures
    lod = tex_lod if (tex_lod > 0.0 and tex.textured and tex.n_levels > 1) else None
    mat = sample_materials(scene, mid, hit.uv, lod=lod)
    if shadows and light_sample and scene.lights.count > 1:
        lighting = _direct_lighting_sampled(scene, hit, hit_live, u[:, 6], mat)
    else:
        smask = _shadow_mask_points(scene, hit.point, hit.normal, hit_live) if shadows else None
        lighting = lit_by_all_lights(scene, hit, mat.albedo, mat.emission, mat.metallic,
                                     mat.occlusion, smask)
    shaded = dispersion_blend(scene, mid, lighting)
    invalid = hit.hit & (hit.material_id >= mats.count)
    magenta = torch.tensor(MAGENTA, dtype=torch.float32, device=dev)
    shaded = torch.where(invalid[:, None], magenta[None, :], shaded)
    radiance = radiance + torch.where(hit_live[:, None], shaded * thr, zero3)

    if last:
        return r.replace(active=torch.zeros_like(live)), radiance

    u0, u1, u2, u3, u4, u5 = (u[:, k] for k in range(6))
    n = hit.normal
    d = r.direction
    entering = dot(d, n) < 0.0
    n_face = torch.where(entering[:, None], n, -n)

    dir_diffuse = cosine_hemisphere(n_face, u0, u1)
    fuzz = torch.stack([u0 * 2.0 - 1.0, u1 * 2.0 - 1.0, u2 * 2.0 - 1.0], -1)
    mirror = reflect(d, n_face)
    dir_metal = normalize(mirror + mat.roughness[:, None] * fuzz)
    metal_absorbed = dot(dir_metal, n_face) <= 0.0

    is_glass = mat.transmission > 0.0
    chan = r.wavelength_channel
    split = is_glass & (chan >= RGB_CHANNEL)
    c_new = torch.clamp((u5 * 3.0).to(torch.int32), max=2)
    eff_chan = torch.where(split, c_new, chan)
    mat_ior = ior_for_channel(mat.ior, eff_chan)
    one = torch.ones_like(mat_ior)
    n1 = torch.where(entering, r.medium_ior, mat_ior)
    n2 = torch.where(entering, mat_ior, one)
    eta = n1 / n2
    cos_i = torch.abs(dot(d, n_face))
    dir_refr, tir = refract(d, n_face, eta)
    fres = torch.clamp(schlick_fresnel(cos_i, n1, n2), 0.0, 1.0)
    do_reflect = tir | (u3 < fres)
    dir_glass = torch.where(do_reflect[:, None], mirror, dir_refr)
    new_medium = torch.where(do_reflect, r.medium_ior, torch.where(entering, mat_ior, one))

    is_metal = ~is_glass & (mat.metallic > 0.5)
    new_dir = torch.where(is_glass[:, None], dir_glass,
                          torch.where(is_metal[:, None], dir_metal, dir_diffuse))
    ray_type = torch.where(is_glass & ~do_reflect, RAY_TRANSMIT, RAY_REFLECT).to(torch.int32)
    # offset along the side of the surface the ray leaves on
    offset = torch.where(dot(new_dir, n_face) >= 0.0, 1.0, -1.0).to(thr.dtype) * 1e-3
    new_origin = hit.point + n_face * offset[:, None]

    throughput = thr * mat.albedo
    onehot = (eff_chan[:, None] == torch.arange(3, device=dev)[None, :]).to(thr.dtype)
    throughput = torch.where(split[:, None], throughput * 3.0 * onehot, throughput)
    alive = hit_live & ~(is_metal & metal_absorbed)
    if do_rr:
        p = torch.clamp(throughput.amax(dim=-1), 0.05, 0.95)
        survive = u4 <= p
        throughput = torch.where((alive & survive)[:, None], throughput / p[:, None], throughput)
        alive = alive & survive

    a1 = alive[:, None]
    return r.replace(
        origin=torch.where(a1, new_origin, r.origin),
        direction=torch.where(a1, new_dir, d),
        ray_type=torch.where(alive, ray_type, r.ray_type),
        bounce_depth=r.bounce_depth + alive.to(torch.int32),
        throughput=torch.where(a1, throughput, thr),
        medium_ior=torch.where(alive & is_glass, new_medium, r.medium_ior),
        wavelength_channel=torch.where(alive, eff_chan, chan),
        active=alive), radiance


def bounce_(scene: Scene, r: WavefrontRays, radiance: torch.Tensor, *, depth: int = 0,
            order: torch.Tensor | None = None, n_live: torch.Tensor | None = None,
            u: torch.Tensor | None = None, qmc=None, shadows: bool, do_rr: bool,
            light_sample: bool = False, tex_lod: float = 0.0, last: bool = False) -> None:
    """One bounce of the pool IN PLACE: the plain version of the bounce
    kernel's own contract (ops/cuda/bounce.py::fused_bounce_, which
    documents the arguments). The lanes worked on are the live ones among
    the first n_live positions of `order`; each gets its continuation
    written over it or is retired, and its radiance added to `radiance`;
    every other lane is left as it is. Uniforms: row i of `u` belongs to
    position i, i.e. to lane order[i]; without `u` each lane gets the QMC
    numbers of its own identity (`pool_uniforms`). Built on `bounce` over
    the whole pool with the other lanes masked out."""
    N = r.count
    dev = r.origin.device
    if u is None:
        u_lane = pool_uniforms(qmc, depth, torch.arange(N, device=dev), N)
    elif order is None:
        u_lane = u
    else:
        u_lane = torch.empty_like(u)
        u_lane[order.long()] = u
    chosen = r.active
    if n_live is not None:
        first = torch.arange(N, device=dev) < n_live
        if order is not None:
            first = torch.zeros_like(first).index_put_((order.long(),), first)
        chosen = chosen & first
    new, rad = bounce(scene, r.replace(active=chosen), u_lane, shadows=shadows, do_rr=do_rr,
                      light_sample=light_sample, tex_lod=tex_lod, last=last)
    for name in ("origin", "direction", "ray_type", "bounce_depth", "throughput", "medium_ior",
                 "wavelength_channel"):
        getattr(r, name).copy_(getattr(new, name))
    r.active.copy_(new.active | (r.active & ~chosen))
    radiance.add_(rad)


def wavefront_single_bounce(scene: Scene, px: torch.Tensor, py: torch.Tensor, width: int,
                            height: int, channel: int = 0) -> torch.Tensor:
    """The reference's shipped wavefront behaviour: one camera ray per pixel,
    one processed bounce, forced termination -> the full RGB before channel
    filtering."""
    rays = camera_wavefront_rays(scene.camera, width, height, px, py, channel)
    hit = trace(scene, rays.origin, rays.direction)
    shaded = apply_dispersion(scene, hit, direct_lighting(scene, hit))
    sky = torch.tensor(SKY_WAVEFRONT, dtype=torch.float32, device=px.device)
    return torch.where(hit.hit[:, None], shaded * rays.throughput, sky[None, :] * rays.throughput)
