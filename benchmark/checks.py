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
Fly frames (driver `fly`): of each frame compared, the reference's own
G-buffer of the whole frame, and at `check_pixels` pixels:
  * `gbuffer_off_share`: the program's G-buffer (PathTracer.gbuffer())
    against the reference's: a stale G-buffer, a wrong camera, a skipped
    warp trace;
  * `filter_off_share`, `filter_mean_abs`: the displayed frame against the
    reference's à-trous filter of the program's own pre-filter mean along
    the reference's G-buffer (a stage followed from the program's state;
    the mean itself is judged by the next three): a skipped filter, one
    along another frame's G-buffer, an altered frame;
  * at the first `path_pixels` of them, the pre-filter mean with each
    pixel's own sample weight against the reference's estimate with
    `check_spp` paths: `empty_share`, `outlier_share` and `luminance_gap`
    (compare_estimates): dropped history, a skipped or misplaced coset
    step, altered samples.
The reference's walks also give the work that the rooflines count
(roofline.py), scaled from the compared pixels to the whole frame or step.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference, generator

CHUNK_RAYS = 1 << 18      # rays the reference traces at once
GBUFFER_RAYS = 1 << 23    # camera rays of the fly frames' G-buffers traced at once
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


def estimate(driver, rs: reference.RefScene, views, spp: int, gen, work):
    """The reference's estimate with `spp` paths at the pixels of `views`
    ([(camera, px, py)]), CHUNK_RAYS paths at a time -> (mean [P,3],
    per-sample luminance variance [P]) on the host."""
    pt = driver.config["program"]
    per = max(CHUNK_RAYS // spp, 1)
    means, variances, chunk, size = [], [], [], 0

    def flush():
        m, v = reference.path_trace(rs, chunk, driver.width, driver.height, spp, gen,
                                    max_depth=pt["max_bounce_depth"],
                                    rr_start=pt["russian_roulette_start"], work=work)
        means.append(m)
        variances.append(v)

    for cam, x, y in views:
        while x.shape[0]:
            take = min(per - size, x.shape[0])
            chunk.append((cam, x[:take], y[:take]))
            size += take
            x, y = x[take:], y[take:]
            if size == per:
                flush()
                chunk, size = [], 0
    if chunk:
        flush()
    return torch.cat(means).cpu().numpy(), torch.cat(variances).cpu().numpy()


def image_reference(driver, rs: reference.RefScene, seed, device, stream=generator.PATHS):
    """The reference's estimate at the compared pixels -> (mean [P,3], the
    per-sample luminance variance [P], Work, (px, py))."""
    tpx, tpy, px, py = _pixels(seed, driver.mix, driver.width, driver.height, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(generator.torch_seed(seed, stream))
    work = reference.Work()
    mean, var = estimate(driver, rs, [(driver.camera(), tpx, tpy)], driver.mix["check_spp"],
                         gen, work)
    return mean, var, work, (px, py)


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


# ---- the fly frame (driver `fly`) ----

def frame_gbuffers(rs: reference.RefScene, cams, width: int, height: int, work) -> list:
    """The reference's G-buffers of whole frames seen from `cams`, at the
    pixel centres, GBUFFER_RAYS rays of them traced at once -> per camera
    (normal [H,W,3], depth [H,W], albedo [H,W,3]) on the scene's device."""
    flat = torch.arange(width * height, device=rs.device)
    rays = [reference.camera_rays(cam, width, height, flat % width, flat // width, dtype=rs.dtype)
            for cam in cams]
    o, d = torch.cat([r[0] for r in rays]), torch.cat([r[1] for r in rays])
    planes = [reference.gbuffer(rs, o[s:s + GBUFFER_RAYS].contiguous(),
                                d[s:s + GBUFFER_RAYS].contiguous(), work)
              for s in range(0, o.shape[0], GBUFFER_RAYS)]
    n, z, a = (torch.cat(p).split(width * height) for p in zip(*planes))
    return [(ni.reshape(height, width, 3), zi.reshape(height, width), ai.reshape(height, width, 3))
            for ni, zi, ai in zip(n, z, a)]


def _at(x, ty, tx) -> np.ndarray:
    """x [H,W,...] (a tensor on any device or a host array) at the pixels
    ty, tx -> a float32 host array."""
    t = torch.as_tensor(x)
    return t[ty.to(t.device), tx.to(t.device)].float().cpu().numpy()


def compare_gbuffers(prog, ref, tol: float) -> float:
    """The share of pixels whose G-buffer entry (normal [P,3], 0 on a miss;
    depth [P]; albedo [P,3]) is off the reference's: a hit on one side and a
    miss on the other, or a normal or albedo channel off by more than `tol`,
    or a hit's depth off by more than `tol` of the reference's."""
    pn, pz, pa = (np.asarray(x, np.float64) for x in prog)
    rn, rz, ra = (np.asarray(x, np.float64) for x in ref)
    p_hit, r_hit = (pn * pn).sum(axis=1) > 0.25, np.isfinite(rz)
    both = p_hit & r_hit
    rz = np.where(both, rz, 1.0)
    off = ((p_hit != r_hit) | (np.abs(pa - ra).max(axis=1) > tol)
           | (both & ((np.abs(pn - rn).max(axis=1) > tol)
                      | (np.abs(np.where(both, pz, 1.0) - rz) > tol * rz))))
    return float(off.mean()) if off.size else 1.0


def compare_estimates(prog, weight, ref, var, mix: dict, frames: int = 1) -> dict:
    """Numbers of the program's pre-filter mean at the compared pixels ([P,3],
    each pixel the mean of its own sample weight `weight` [P]; `frames`
    frames of P / frames pixels each, one after another) beside the
    reference's estimate (mean [P,3], per-sample luminance variance [P] over
    check_spp paths), by luminance (R + G + B):
      * `empty_share`: the median over the frames of each frame's share of
        pixels with no sample weight: a frame whose view the warp cannot
        carry over (the camera entering a box) empties most of its pixels
        where no fault is, which the median leaves out;
      * `outlier_share`: of the other pixels, the share whose gap exceeds
        OUTLIER_Z standard errors of the gap;
      * `luminance_gap`: |the summed gap| over the summed reference, of the
        other pixels: a bias that each pixel's noise hides (1 where every
        pixel is empty)."""
    w = np.asarray(weight, np.float64)
    seen = w > 0
    empty = float(np.median([1.0 - f.mean() for f in np.split(seen, frames)]))
    if not seen.any():
        return {"empty_share": empty, "outlier_share": 1.0, "luminance_gap": 1.0}
    lp = np.asarray(prog, np.float64).sum(axis=1)[seen]
    lr = np.asarray(ref, np.float64).sum(axis=1)[seen]
    gap_var = np.asarray(var, np.float64)[seen] * (1.0 / mix["check_spp"] + 1.0 / w[seen])
    z2 = (lp - lr) ** 2 / np.maximum(gap_var, 1e-8)
    return {"empty_share": empty, "outlier_share": float((z2 > OUTLIER_Z ** 2).mean()),
            "luminance_gap": float(abs((lp - lr).sum()) / max(lr.sum(), 1e-12))}


def fly_numbers(driver, frames, side, estimates, device, dtype=torch.float32):
    """The fly frame's numbers of `frames` (frame numbers). For each frame,
    `side(i, normal, depth, albedo)`, handed the reference's own G-buffer of
    it, gives what is judged, whole frames (tensors or host arrays): `shown`
    [H,W,3], the frame displayed; `gbuffer` (normal, depth, albedo);
    `filter_input` [H,W,3], the pre-filter mean it was filtered from. The reference
    filters that along its G-buffer. `estimates(views)` gives the judged
    pre-filter means and sample weights at the estimate's pixels of every
    frame ([(camera, px, py)]), which the reference's own estimate judges ->
    (numbers, Work of the G-buffers, Work of the estimate, the reference
    tree's bytes)."""
    mix, W, H = driver.mix, driver.width, driver.height
    rs = scene_for(driver, device, dtype)
    tpx, tpy, _, _ = _pixels(driver.seed, mix, W, H, device)
    k = mix["path_pixels"]
    gen = torch.Generator(device=device)
    gen.manual_seed(generator.torch_seed(driver.seed, generator.PATHS))
    cams = driver.cameras(frames)
    primary, paths = reference.Work(), reference.Work()
    gb_prog, gb_ref, shown, filtered = [], [], {}, {}
    gbuffers = frame_gbuffers(rs, [cams[i] for i in frames], W, H, primary)
    for i, (normal, depth, albedo) in zip(frames, gbuffers):
        got = side(i, normal, depth, albedo)
        mean = torch.as_tensor(got["filter_input"]).to(device=device, dtype=dtype)
        f = reference.atrous(mean, normal, depth, albedo, mix["denoise_iterations"])
        filtered[i] = _at(f, tpy, tpx)
        shown[i] = _at(got["shown"], tpy, tpx)
        gb_prog.append(tuple(_at(x, tpy, tpx) for x in got["gbuffer"]))
        gb_ref.append(tuple(_at(x, tpy, tpx) for x in (normal, depth, albedo)))
    views = [(cams[i], tpx[:k], tpy[:k]) for i in frames]
    prog_mean, weight = estimates(views)
    ref_mean, var = estimate(driver, rs, views, mix["check_spp"], gen, paths)
    filt = compare_frames(shown, filtered, mix, u8=False)
    nums = {"gbuffer_off_share": compare_gbuffers(
                [np.concatenate([g[j] for g in gb_prog]) for j in range(3)],
                [np.concatenate([g[j] for g in gb_ref]) for j in range(3)], mix["off_tol"]),
            "filter_off_share": filt["off_share"], "filter_mean_abs": filt["mean_abs"],
            **compare_estimates(prog_mean, weight, ref_mean, var, mix, len(frames))}
    return nums, primary, paths, rs.tree.table_bytes()


def fly_check(driver, outputs: dict, device, dtype=torch.float32):
    """The fly frames' numbers (fly_numbers) of the program's outputs: frame
    number -> its displayed frame `shown`, G-buffer planes, pre-filter
    `mean` and sample `weight`, [H,W,...] tensors as the driver kept them
    -> (numbers, work a frame, frames compared, the reference tree's
    bytes). The work: the G-buffer's walk of a whole frame, and the paths
    of one coset (1 / interleave of the pixels)."""
    mix = driver.mix
    frames = sorted(outputs)

    def side(i, *_):
        out = outputs[i]
        return {"shown": out["shown"], "filter_input": out["mean"],
                "gbuffer": (out["normal"], out["depth"], out["albedo"])}

    def estimates(views):
        at = lambda name: np.concatenate([_at(outputs[i][name], y, x)
                                          for i, (_, x, y) in zip(frames, views)])
        return at("mean"), at("weight")

    nums, primary, paths, tree_bytes = fly_numbers(driver, frames, side, estimates, device, dtype)
    coset = driver.width * driver.height / mix["interleave"]
    per_path = coset / max(mix["path_pixels"] * mix["check_spp"] * len(frames), 1)
    work = {"primary": primary.scaled(1.0 / max(len(frames), 1)), "paths": paths.scaled(per_path)}
    return nums, work, len(frames), tree_bytes


def fly_control(driver, frames, device) -> dict:
    """The fly check's numbers with the reference in bfloat16 in the
    program's place: its G-buffer; its filter, along that G-buffer, of a
    noisy image made from the seed (the float32 reference's albedo times
    uniform noise, which the float32 filter takes as well); its estimate
    with check_spp paths of random numbers of its own."""
    mix, W, H = driver.mix, driver.width, driver.height
    lo = scene_for(driver, device, torch.bfloat16)
    gen = torch.Generator(device=device)
    gen.manual_seed(generator.torch_seed(driver.seed, generator.CONTROL))
    cams = driver.cameras(frames)

    def side(i, normal, depth, albedo):
        noise = torch.rand(albedo.shape, generator=gen, device=device, dtype=torch.float32)
        image = (albedo.float() * noise).to(torch.bfloat16)
        n, z, a = frame_gbuffers(lo, [cams[i]], W, H, reference.Work())[0]
        return {"shown": reference.atrous(image, n, z, a, mix["denoise_iterations"]),
                "filter_input": image.float(), "gbuffer": (n, z, a)}

    def estimates(views):
        mean, _ = estimate(driver, lo, views, mix["check_spp"], gen, reference.Work())
        return mean, np.full(mean.shape[0], float(mix["check_spp"]))

    return fly_numbers(driver, frames, side, estimates, device)[0]
