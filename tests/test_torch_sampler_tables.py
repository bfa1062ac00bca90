"""The texture sampler's pack-time tables (ops/cuda/texshade.py) against a
model of the loops they replace, on the CPU.

The kernels (csrc/texsample.cuh) read a mip level as one record of
`level_records`, wrap with a mask where the level's size is a power of two,
and load each row of a bilinear quad as one pair of `texel_pairs`. Here each
table is held to a numpy model of what the sampler computed before per
sample (the level walk, floor_mod, the neighbour gather), for every texture
and level of the zoo, the synthetic scene (all three wraps, odd sizes) and a
glTF fixture (CLAMP and MIRRORED samplers); then a model of the whole new
address path is held bit for bit to the plain sampler `ops/texture.py`."""

import numpy as np
import pytest
import torch

import torch_bridge  # noqa: F401  (thread cap)
from torch_scenes import random_gbuffer, synthetic_textured_scene
from gltf_fixtures import write_gltf
from test_torch_gltf import rich_gltf

from gpu_raytracer_tpu_torch.ops.render import gbuffer_planes, split_gbuffer
from gpu_raytracer_tpu_torch.models.gltf import scene_from_gltf
from gpu_raytracer_tpu_torch.ops import texture
from gpu_raytracer_tpu_torch.ops.cuda.texshade import (LEVEL_WORDS, META_WORDS, MAP_SLOTS,
                                                       pack_shade_tables, texture_shade)
from gpu_raytracer_tpu_torch.ops.shading import shade_deferred
from gpu_raytracer_tpu_torch.utils.procgen import make_courtyard_scene, make_zoo_scene

TEX_CHUNK = 127


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    gltf = write_gltf(tmp_path_factory.mktemp("gltf") / "rich.gltf", rich_gltf())
    return {"zoo_multi_slot": make_zoo_scene(800, seed=0, multi_slot=True),
            "synthetic": synthetic_textured_scene(0, mips=4),
            "courtyard": make_courtyard_scene(500, seed=0, textured=True),
            "gltf_rich": scene_from_gltf(gltf)}


NAMES = ["zoo_multi_slot", "synthetic", "courtyard", "gltf_rich"]


def level_walk(off, w, h, srows, lod):
    """The per-sample loop the kernels ran before (texsample.cuh tex_level):
    level l+1 starts (h_l + 1) * srows_l rows after level l, sizes halved."""
    for _ in range(lod):
        off += (h + 1) * srows
        w = max(w // 2, 1)
        h = max(h // 2, 1)
        srows = (w + TEX_CHUNK - 1) // TEX_CHUNK
    return off, w, h, srows


@pytest.mark.parametrize("name", NAMES)
def test_level_records_are_the_level_walk(scenes, name):
    scene = scenes[name]
    tex = scene.textures
    st = pack_shade_tables(scene)
    assert tex.count > 0 and st.levels.shape == (tex.count, tex.n_levels, LEVEL_WORDS)
    for t in range(tex.count):
        start = (int(tex.offset_row[t]), int(tex.width[t]), int(tex.height[t]),
                 int(tex.srows[t]))
        for lod in range(tex.n_levels):
            assert tuple(st.levels[t, lod].tolist()) == level_walk(*start, lod), (t, lod)
    # the kernels reach a slot's records through its TexMeta's last word, counted in
    # 16-byte records from the start of the maps table, in the same buffer
    assert st.levels.data_ptr() == st.maps.data_ptr() + st.maps.numel() * 4
    records = torch.cat([st.maps.reshape(-1), st.levels.reshape(-1)]).view(-1, LEVEL_WORDS)
    ti = scene.materials.texture_indices[:, list(MAP_SLOTS)]
    M = ti.shape[0]
    assert st.maps.shape == (M, len(MAP_SLOTS), META_WORDS)
    for m in range(M):
        for k in range(len(MAP_SLOTS)):
            if ti[m, k] == texture.NO_TEXTURE:
                assert st.maps[m, k, 0] == 0
                continue
            t = int(ti[m, k])
            first = int(st.maps[m, k, 7])
            for lod in range(int(tex.levels[t])):
                assert torch.equal(records[first + lod], st.levels[t, lod])


def kernel_wrap_mod(c: np.ndarray, m: int) -> np.ndarray:
    """texsample.cuh wrap_mod: a mask where m is a power of two, else the
    floor modulo (C's % corrected for the sign)."""
    if m & (m - 1) == 0:
        return c & (m - 1)
    r = np.fmod(c, m)
    return np.where(r < 0, r + m, r)


def kernel_tap_axis(c: np.ndarray, size: int, mode: int, f: np.ndarray):
    """texsample.cuh tap_axis on int32 coordinates and f32 weights."""
    n = max(size, 1)
    f = f.copy()
    if mode == 1:
        cw = np.minimum(np.maximum(c, 0), n - 1)
        f[c < 0] = 0.0
        return cw, f
    if mode == 2:
        per = kernel_wrap_mod(c, 2 * n)
        cw = np.where(per < n, per, 2 * n - 1 - per)
        flip = per >= n
        f = np.where(flip, np.where(cw == 0, np.float32(0.0), np.float32(1.0) - f), f)
        return np.where(flip, np.maximum(cw - 1, 0), cw), f.astype(np.float32)
    return kernel_wrap_mod(c, n), f


@pytest.mark.parametrize("name", NAMES)
def test_wrap_choice_matches_floor_mod_at_every_level(scenes, name):
    """Every level size of the scene: the mask (power of two) or the floor
    modulo gives floor_mod's integers over -3 size .. 3 size, and the whole
    tap axis equals the plain sampler's for all three wraps."""
    st = pack_shade_tables(scenes[name])
    sizes = sorted(set(st.levels[..., 1].reshape(-1).tolist())
                   | set(st.levels[..., 2].reshape(-1).tolist()))
    assert 1 in sizes
    rng = np.random.default_rng(0)
    for size in sizes:
        c = np.arange(-3 * size, 3 * size + 1, dtype=np.int32)
        for m in (size, 2 * size):
            assert np.array_equal(kernel_wrap_mod(c, m), np.mod(c, m)), m
        f = rng.random(c.shape[0], dtype=np.float32)
        tc, ts = torch.from_numpy(c.astype(np.int64)), torch.full((c.shape[0],), size)
        for mode in (0, 1, 2):
            tm = torch.full_like(ts, mode)
            want = texture._wrap(tc, ts, tm).numpy()
            wf = np.where((mode == 1) & (c < 0), np.float32(0.0), f)
            flip = texture._mirror_flip(tc, ts, tm).numpy()
            wf = np.where(flip, np.where(want == 0, np.float32(0.0), np.float32(1.0) - wf), wf)
            want = np.where(flip, np.maximum(want - 1, 0), want)
            cw, got_f = kernel_tap_axis(c, size, mode, f)
            assert np.array_equal(cw, want), (size, mode)
            assert np.array_equal(got_f.view(np.int32), wf.astype(np.float32).view(np.int32))


@pytest.mark.parametrize("name", NAMES)
def test_texel_pairs_are_the_neighbour_gather(scenes, name):
    scene = scenes[name]
    st = pack_shade_tables(scene)
    data = scene.textures.data_u32
    words = torch.where(data >= 2**31, data - 2**32, data).to(torch.int32)
    assert st.atlas.shape == (data.numel(), 2) and st.atlas.dtype == torch.int32
    assert torch.equal(st.atlas[:, 0], words)
    assert torch.equal(st.atlas[:-1, 1], words[1:]) and st.atlas[-1, 1] == 0
    # a tap's base never sits on lane 127, the guard: a + 1 stays in its atlas row
    assert (data.numel() % 128) == 0


def _f32_exponent(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) >> 23) - 127


def model_sample(st, tex, idx, uv, x, how):
    """The kernels' sample (texsample.cuh begin_sample / finish_sample) of
    textures idx [N] at uv [N,2] from the pack-time tables alone: level
    records, the wrap above, two texel-pair loads per level. `how` is
    "explicit" (x the level), "nearest" or "trilinear" (x the footprint)."""
    lv = tex.levels[idx]
    w0 = tex.width[idx].to(torch.float32)
    mode = tex.wrap[idx]
    N = idx.shape[0]
    frac = torch.zeros(N)
    lod1 = None
    if tex.n_levels <= 1:
        lod0 = torch.zeros(N, dtype=torch.int64)
    elif how == "explicit":
        lod0 = torch.minimum(torch.clamp(x, min=0.0), lv.to(torch.float32) - 1.0).long()
    else:
        foot = torch.clamp(x * w0, min=1e-20)
        if how == "nearest":
            e = _f32_exponent(foot * np.float32(1.4142135))
            lod0 = torch.minimum(torch.clamp(e, min=0), lv - 1).long()
        else:
            e = _f32_exponent(foot).to(torch.float32)
            mant = (foot.view(torch.int32) & 0x7FFFFF).to(torch.float32) * np.float32(2.0**-23)
            lvf = lv.to(torch.float32)
            l0 = torch.minimum(torch.clamp(e, min=0.0), lvf - 1.0)
            frac = torch.where((e >= 0.0) & (e < lvf - 1.0), mant, torch.zeros_like(mant))
            lod0, lod1 = l0.long(), torch.minimum(l0 + 1.0, lvf - 1.0).long()

    def quad(lod):
        off, w, h, sr = (st.levels[idx, lod, j].long() for j in range(4))
        uf = uv[:, 0] * w.to(torch.float32) - 0.5
        vf = uv[:, 1] * h.to(torch.float32) - 0.5
        x0f, y0f = torch.floor(uf), torch.floor(vf)
        fx, fy = (uf - x0f).numpy(), (vf - y0f).numpy()
        xs, ys = x0f.to(torch.int32).numpy(), y0f.to(torch.int32).numpy()
        xw, yw = np.empty(N, np.int64), np.empty(N, np.int64)
        for r in range(N):   # the kernel's per-lane wrap
            a, fx[r:r + 1] = kernel_tap_axis(xs[r:r + 1], int(w[r]), int(mode[r]), fx[r:r + 1])
            b, fy[r:r + 1] = kernel_tap_axis(ys[r:r + 1], int(h[r]), int(mode[r]), fy[r:r + 1])
            xw[r], yw[r] = a[0], b[0]
        xw, yw = torch.from_numpy(xw), torch.from_numpy(yw)
        k = xw // TEX_CHUNK
        a = (off + yw * sr + k) * 128 + (xw - k * TEX_CHUNK)
        top, bot = st.atlas[a], st.atlas[a + sr * 128]
        fx, fy = torch.from_numpy(fx)[:, None], torch.from_numpy(fy)[:, None]
        byte = lambda t: ((t.long() & 0xFFFFFFFF)[:, None] >> torch.tensor([0, 8, 16, 24])
                          & 0xFF).to(torch.float32)
        gx, gy = 1.0 - fx, 1.0 - fy
        t_ = byte(top[:, 0]) * gx + byte(top[:, 1]) * fx
        b_ = byte(bot[:, 0]) * gx + byte(bot[:, 1]) * fx
        return (t_ * gy + b_ * fy) * np.float32(1.0 / 255.0)

    r0 = quad(lod0)
    if lod1 is None:
        return r0
    return r0 * (1.0 - frac)[:, None] + quad(lod1) * frac[:, None]


@pytest.mark.parametrize("how", ["explicit", "nearest", "trilinear"])
@pytest.mark.parametrize("name", NAMES)
def test_table_sampler_is_bit_equal_to_the_plain_sampler(scenes, name, how):
    scene = scenes[name]
    tex = scene.textures
    st = pack_shade_tables(scene)
    rng = np.random.default_rng(11)
    N = 768
    idx = torch.from_numpy(rng.integers(0, tex.count, N))
    uv = torch.from_numpy(rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32))
    if how == "explicit":
        x = torch.full((N,), float(rng.choice([0.0, 1.0, 2.5, 9.0])), dtype=torch.float32)
        want = texture.sample_texture(tex, idx, uv, lod=x)
    else:
        x = torch.from_numpy(np.exp2(rng.uniform(-12.0, 1.0, N)).astype(np.float32))
        want = texture.sample_texture(tex, idx, uv, lam=x, trilinear=how == "trilinear")
    got = model_sample(st, tex, idx, uv, x, how)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gbuffer_planes_hold_the_rows_words():
    """The deferred trace kernel's planes [2,N,4] and the plain rows [N,8]
    carry the same words: split_gbuffer reads both, the texture shade's
    plain version shades the planes as shade_deferred the rows, and the
    texture shade takes planes only."""
    scene = synthetic_textured_scene(0, mips=4)
    rows = torch.from_numpy(random_gbuffer(np.random.default_rng(3), 4096,
                                           scene.materials.count, mips=True))
    planes = gbuffer_planes(rows)
    assert planes.shape == (2, 4096, 4) and planes.is_contiguous()
    bits = lambda t: t.contiguous().view(torch.int32)   # a miss's id is NaN bits
    assert torch.equal(bits(planes[0]), bits(rows[:, :4]))
    assert torch.equal(bits(planes[1]), bits(rows[:, 4:]))
    for a, b in zip(split_gbuffer(planes), split_gbuffer(rows)):
        assert torch.equal(a, b)
    st = pack_shade_tables(scene)
    S, mat, uv, lam = split_gbuffer(rows)
    for trilinear in (False, True):
        assert torch.equal(texture_shade(st, planes, sky=(0.1, 0.2, 0.3), trilinear=trilinear),
                           shade_deferred(scene, S, mat, uv, sky_color=(0.1, 0.2, 0.3), lam=lam,
                                          trilinear=trilinear))
    for bad in (rows, planes[:, :, :3].contiguous()):
        with pytest.raises(ValueError, match="planes"):
            texture_shade(st, bad)
