"""Scenes and ray batches that the CPU tests and chip_smoke.py's card
phases share: a small textured scene with every wrap mode and map slot,
random G-buffers over it, and shadow rays from a frame's hits.

The package is imported inside each function: chip_ab.py runs
chip_smoke.py against the package of another tree, put first on sys.path
after this module is loaded.
"""


def light_shadow_rays(scene, o, d, t, h, n, n_shadow, directional=False):
    """Shadow rays from n_shadow of the camera rays' hits (a seeded choice,
    in the frame's order): from p + n * 1e-3 toward the first point light,
    max_t its distance - 1e-3, or with `directional` against the first
    directional light's direction, max_t 3e38, as the frame kernels cast
    them (render_common.cuh::light_intensity) -> (origin, direction, max_t)."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.ops.linalg import dot

    hits = torch.nonzero(h).squeeze(1).cpu().numpy()
    pick = np.sort(np.random.default_rng(0).choice(hits, min(n_shadow, hits.shape[0]),
                                                   replace=False))
    pick = torch.from_numpy(pick).to(o.device)
    L = scene.lights
    p = o[pick] + d[pick] * t[pick, None]
    so = (p + n[pick] * 1e-3).contiguous()
    if directional:
        li = int(torch.nonzero(L.light_type == 0)[0])
        sd = (-L.direction[li]).expand_as(so).contiguous()
        return so, sd, torch.full((so.shape[0],), 3.0e38, device=o.device)
    li = int(torch.nonzero(L.light_type == 1)[0])
    to_light = L.position[li][None, :] - p
    dist = torch.sqrt(dot(to_light, to_light))
    sd = (to_light / dist[:, None]).contiguous()
    return so, sd, (dist - 1e-3).contiguous()


def synthetic_textured_scene(seed: int = 0, n_mats: int = 6, mips: int = 1,
                             degenerate_glass: bool = False, device="cpu"):
    """The default scene's geometry (spheres and triangles) with n_mats
    random materials over three random RGBA8 textures, one per wrap mode:
    every second material has a base-colour map, every third metallic-
    roughness, occlusion and emissive maps. With mips=1 it is, draw for
    draw, the JAX package's texture-shade test scene
    (tests/test_texshade.py::_textured_scene)."""
    import numpy as np

    from gpu_raytracer_tpu_torch.models.geometry import Textures
    from gpu_raytracer_tpu_torch.models.material import MaterialBuilder
    from gpu_raytracer_tpu_torch.models.scene import build_default_scene, prepare_scene

    rng = np.random.default_rng(seed)
    mb = MaterialBuilder()
    imgs = [rng.integers(0, 256, size=(5 + 3 * i, 9 + 11 * i, 4), dtype=np.uint8)
            for i in range(3)]
    for i in range(n_mats):
        ti = np.full(8, 0xFFFFFFFF, np.uint32)
        if i % 2 == 0:
            ti[0] = i % 3
        if i % 3 == 0:
            ti[1] = (i + 1) % 3
            ti[3] = (i + 2) % 3
            ti[4] = i % 3
        ior = 1.0 + 0.5 * (i % 3)
        trans = 0.5 * (i % 2)
        if not degenerate_glass and trans > 0.0 and ior == 1.0:
            ior = 1.3   # ior 1 with transmission is 0/0 in the dispersion blend
        mb.add(albedo=rng.uniform(0.2, 1.0, 3), metallic=float(i % 2), roughness=0.5,
               emission=rng.uniform(0, 0.3, 3), ior=ior, transmission=trans,
               texture_indices=ti)
    tex = Textures.from_images(imgs, wrap=[0, 1, 2], mips=mips)
    base = build_default_scene()
    return prepare_scene(base.camera, base.spheres, base.mesh, mb.build(), base.lights,
                         textures=tex, device=device)


def random_gbuffer(rng, n: int, n_mats: int, mips: bool = False):
    """[n,8] f32 G-buffer of random rays: light sums in [0, 3), material ids
    from -1 (a miss) to n_mats + 1 (invalid), uvs in [-1.5, 2.5) (every wrap
    period), mip footprints 0 or (mips) from 2^-10 to 1."""
    import numpy as np

    light = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    mat = rng.integers(-1, n_mats + 2, n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lam = (np.exp2(rng.uniform(-10.0, 0.0, n)) if mips else np.zeros(n)).astype(np.float32)
    return np.concatenate([light, mat.view(np.float32)[:, None], uv, lam[:, None],
                           np.zeros((n, 1), np.float32)], axis=1)
