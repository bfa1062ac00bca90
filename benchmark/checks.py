"""The comparison that decides `correct`: the program's outputs of the window
against the plain reference (reference.py), number by number, each against
its limit in the mix file (`limits`).

Frames (driver `viewer`): at `check_pixels` pixels drawn from the seed, of
each frame the window picked (`check_frames` drawn from the seed, and the
window's last), the program's colour beside the reference's:
  * `off_share`: the share of compared pixels whose largest channel differs
    by more than `off_tol` (1e-3 for f32 frames, one level for u8 ones): a
    hit on another triangle, a wrong shadow, a stale or missing frame;
  * `mean_abs`: the mean absolute difference over every compared channel
    (in levels for u8): a small error spread over every pixel.
Path-traced image (driver `pathtracer`): the accumulated image at
`check_pixels` pixels beside the reference's own estimate with
`check_spp` paths a pixel, by luminance (R + G + B):
  * `outlier_share`: the share of compared pixels whose gap exceeds
    OUTLIER_Z standard errors of the gap (the reference's per-sample
    variance over its samples and over the steps the run called): a handful
    for a sound run, a third or more where the geometry or the shading is
    off pixel by pixel, nearly all where the accumulation stopped.
The reference's walks also give the work that the rooflines count
(roofline.py), scaled from the compared pixels to the whole frame or step.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference, generator

CHUNK_RAYS = 1 << 18      # rays the reference traces at once
OUTLIER_Z = 5.0           # a pixel off by more than this many standard errors is an outlier


def scene_for(driver, device, dtype=torch.float32) -> reference.RefScene:
    """The reference's scene of the driver's configuration."""
    p = driver.config["program"]
    return reference.ref_scene(driver.inputs, device, dtype, mips=p["texture_mips"],
                               budget_rows=driver.config["scene"].get("atlas_budget_rows"),
                               width=p["bvh_width"], leaf=p["bvh_leaf_size"])


def _pixels(seed, mix, width, height, device):
    px, py = generator.pick_pixels(seed, generator.PIXELS, mix["check_pixels"], width, height)
    return (torch.as_tensor(px, device=device), torch.as_tensor(py, device=device), px, py)


def frame_references(driver, rs: reference.RefScene, frames, seed, device, u8: bool):
    """The reference's colours at the compared pixels of each frame number
    in `frames` -> ({frame: [P,3] f32 or u8 host array}, Work, (px, py))."""
    mix, W, H = driver.mix, driver.width, driver.height
    tpx, tpy, px, py = _pixels(seed, mix, W, H, device)
    cams = driver.cameras(frames)
    work = reference.Work()
    out = {}
    for i in frames:
        o, d = reference.camera_rays(cams[i], W, H, tpx, tpy, dtype=rs.dtype)
        pix = reference.pixel_scale(cams[i], H)
        cols = []
        for s in range(0, o.shape[0], CHUNK_RAYS):
            cols.append(reference.whitted(rs, o[s:s + CHUNK_RAYS].contiguous(),
                                          d[s:s + CHUNK_RAYS].contiguous(),
                                          driver.config["shadows"], work, pix))
        c = torch.cat(cols)
        out[i] = (reference.srgb_u8(c) if u8 else c).cpu().numpy()
    return out, work, (px, py)


def compare_frames(prog: dict, ref: dict, mix: dict, u8: bool) -> dict:
    """Numbers of the program's frames (picked pixels, [P,3]) beside the
    reference's."""
    tol = mix["off_tol_u8"] if u8 else mix["off_tol"]
    diffs = []
    for i, p in prog.items():
        a = np.asarray(p, np.float64)
        b = np.asarray(ref[i], np.float64)
        diffs.append(np.abs(a - b))
    d = np.concatenate(diffs) if diffs else np.full((1, 3), np.inf)
    return {"off_share": float((d.max(axis=1) > tol).mean()), "mean_abs": float(d.mean()),
            "frames": len(diffs)}


def viewer_check(driver, outputs: dict, device, dtype=torch.float32):
    """The frames' numbers -> (numbers, work per frame, frames compared,
    the reference tree's bytes)."""
    u8 = driver.present
    rs = scene_for(driver, device, dtype)
    ref, work, (px, py) = frame_references(driver, rs, sorted(outputs), driver.seed, device, u8)
    prog = {i: img[py, px] for i, img in outputs.items()}
    nums = compare_frames(prog, ref, driver.mix, u8)
    per = driver.width * driver.height / max(work.rays, 1)
    return nums, work.scaled(per), nums.pop("frames"), rs.tree.table_bytes()


def image_reference(driver, rs: reference.RefScene, seed, device, stream=generator.PATHS):
    """The reference's estimate at the compared pixels -> (mean [P,3], the
    per-sample luminance variance [P], Work, (px, py))."""
    mix = driver.mix
    pt = driver.config["program"]
    W, H = driver.width, driver.height
    tpx, tpy, px, py = _pixels(seed, mix, W, H, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(generator.torch_seed(seed, stream))
    spp = mix["check_spp"]
    per = max(CHUNK_RAYS // spp, 1)
    work = reference.Work()
    means, variances = [], []
    for s in range(0, tpx.shape[0], per):
        m, v = reference.path_trace(rs, driver.camera(), W, H, tpx[s:s + per], tpy[s:s + per],
                                    spp, gen, max_depth=pt["max_bounce_depth"],
                                    rr_start=pt["russian_roulette_start"], work=work)
        means.append(m)
        variances.append(v)
    return (torch.cat(means).cpu().numpy(), torch.cat(variances).cpu().numpy(), work,
            (px, py))


def compare_images(prog: np.ndarray, samples: int, ref: np.ndarray, var: np.ndarray,
                   mix: dict) -> dict:
    """Numbers of the program's image at the compared pixels ([P,3], the
    mean of `samples` samples) beside the reference's estimate there (mean
    [P,3], per-sample luminance variance [P] over check_spp samples)."""
    lp = np.asarray(prog, np.float64).sum(axis=1)
    lr = np.asarray(ref, np.float64).sum(axis=1)
    # the gap's variance: the reference's mean of check_spp samples and the
    # program's of `samples`, each sample's variance estimated by the
    # reference (a floor for pixels whose samples all agree, as sky pixels do)
    gap_var = np.asarray(var, np.float64) * (1.0 / mix["check_spp"] + 1.0 / max(samples, 1))
    z2 = (lp - lr) ** 2 / np.maximum(gap_var, 1e-8)
    return {"outlier_share": float((z2 > OUTLIER_Z ** 2).mean())}


def pathtracer_check(driver, image: np.ndarray, device, dtype=torch.float32):
    """The image's numbers -> (numbers, work per step, pixels compared,
    the reference tree's bytes)."""
    rs = scene_for(driver, device, dtype)
    ref, var, work, (px, py) = image_reference(driver, rs, driver.seed, device)
    nums = compare_images(image[py, px], driver.steps_called, ref, var, driver.mix)
    per = driver.width * driver.height / (ref.shape[0] * driver.mix["check_spp"])
    return nums, work.scaled(per), ref.shape[0], rs.tree.table_bytes()


def judge(nums: dict, limits: dict) -> tuple[bool, list]:
    """-> (every number within its limit, [(name, number, limit)])."""
    rows = [(k, nums[k], limits[k]) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
