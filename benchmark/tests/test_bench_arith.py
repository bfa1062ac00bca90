"""The yardstick's arithmetic on hand-made cases: the least times, the
percentile, the idle share and the breakdown, the comparisons, and the
benchmark's own walk against a brute-force test of every triangle."""

import numpy as np
import pytest
import torch

from benchmark import bvh, checks, roofline, run, scenes
from benchmark.drivers.common import percentile


def test_least_time_is_the_larger_bound():
    assert roofline.least_ms(3.35e12, 0.0) == pytest.approx(1e3)
    assert roofline.least_ms(0.0, 67e12) == pytest.approx(1e3)
    assert roofline.least_ms(3.35e9, 67e12) == pytest.approx(1e3)
    assert roofline.walk_flops({"slots": 20, "tests": 3}) == 20 * 25 + 3 * 54


def test_frame_and_step_counts():
    tables = {"tree_bytes": 1000, "materials": 2, "lights": 1}
    w = {"slots": 200, "tests": 10, "hits": 5, "rays": 10}
    f = roofline.whitted_frame(w, tables, pixels=10, lights=2)
    assert f["bytes"] == 10 * 20 + 1000 + 2 * 28 + 40
    assert f["flops"] == 200 * 25 + 10 * 54 + 5 * 2 * 120
    s = roofline.path_step(dict(w, rays=30), tables, paths=10, launches=5)
    assert s["bytes"] == 30 * 73 + 20 * 52 + 10 + 5 * (1000 + 56 + 40)
    assert s["flops"] == 200 * 25 + 10 * 54 + 5 * 120 + 20 * 150


def test_fly_frame_counts():
    tables = {"tree_bytes": 1000, "materials": 2, "lights": 1}
    primary = {"slots": 400, "tests": 20, "hits": 16, "rays": 16}
    paths = {"slots": 200, "tests": 10, "hits": 5, "rays": 12}
    f = roofline.fly_frame(primary, paths, tables, pixels=16, interleave=4, launches=5, passes=3)
    assert f["warp_ms"] == roofline.least_ms(16 * (8 + 28 + 20 + 16) + 1096, 400 * 25 + 20 * 54)
    assert f["coset_ms"] == roofline.path_step(paths, tables, 4, 5)["least_ms"]
    assert f["filter_ms"] == roofline.least_ms(16 * (3 * 48 + 72), 16 * 3 * 25 * 30)
    assert f["least_ms"] == f["warp_ms"] + f["coset_ms"] + f["filter_ms"]


def test_fly_readers_count_the_burst_a_frame():
    t = _trace([("k", 10.0, 20.0, "kernel"), ("c", 50.0, 10.0, "gpu_memcpy"),
                ("m", 55.0, 10.0, "gpu_memset")])
    t.work = {"fly": 0.0075}                  # ms a frame, over 35 busy us / 2 frames
    assert run.load_module("metrics", "launches_per_frame").read(t) == 1.5
    assert run.load_module("metrics", "fly_roofline").read(t) == pytest.approx(
        100.0 * 0.0075 / 0.0175)
    t.work = {"k2": 0.01}                     # another cell's least time: nothing to read
    assert run.load_module("metrics", "fly_roofline").read(t) is None


def test_percentile_interpolates():
    assert percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0


def _trace(device, start=0.0, end=100.0):
    burst = dict(device=device, notes=[("enqueue", 0.0, 30.0), ("wait", 30.0, 70.0)],
                 start_us=start, end_us=end, iterations=2)
    return run.Trace("frame", {}, burst, {"k2": 0.01}, {}, False)


def test_busy_time_is_the_union_of_device_intervals():
    t = _trace([("k", 10.0, 20.0, "kernel"), ("k", 15.0, 20.0, "kernel"),
                ("c", 50.0, 10.0, "gpu_memcpy"), ("k", 95.0, 10.0, "kernel")])
    assert t.busy_us() == pytest.approx(25.0 + 10.0 + 5.0)
    assert t.kernel_us("k") == (pytest.approx(50.0), 3)


def test_idle_gaps_are_named_by_the_open_span():
    t = _trace([("void rt::a_kernel<4>(float*)", 10.0, 20.0, "kernel"),
                ("b", 80.0, 5.0, "kernel")])
    b = run.breakdown(t)
    assert b["device_ops"][0] == ["rt::a_kernel", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["wait", pytest.approx(50e-6)]
    assert len(b["idle_gaps"]) == 3 and len(b["device_ops"]) == 2


def test_frame_comparison_counts_pixels_off():
    ref = {0: np.zeros((4, 3), np.float32)}
    prog = {0: np.array([[0, 0, 0], [0.002, 0, 0], [0.0005, 0, 0], [0, 0, 0]], np.float32)}
    nums = checks.compare_frames(prog, ref, {"off_tol": 1e-3, "off_tol_u8": 1}, u8=False)
    assert nums["off_share"] == 0.25
    assert nums["mean_abs"] == pytest.approx(0.0025 / 12)
    assert checks.compare_frames({}, ref, {"off_tol": 1e-3}, False)["off_share"] == 1.0


def test_image_comparison():
    mix = {"check_spp": 100}
    ref = np.ones((8, 3))
    var = np.full(8, 0.09)          # standard error of a gap: sqrt(0.09 / 100 + 0.09 / 100)
    assert checks.compare_images(ref, 100, ref, var, mix) == {"outlier_share": 0.0}
    # a gap of 0.3 is 7 standard errors, one of 0.15 is 3.5
    assert checks.compare_images(ref * 1.1, 100, ref, var, mix)["outlier_share"] == 1.0
    assert checks.compare_images(ref * 1.05, 100, ref, var, mix)["outlier_share"] == 0.0
    half = ref.copy()
    half[::2] *= 1.2
    assert checks.compare_images(half, 100, ref, var, mix)["outlier_share"] == 0.5
    # fewer samples on the program's side widen the gap's error: 0.3 is 4.7 of them at 20
    assert checks.compare_images(ref * 1.1, 20, ref, var, mix)["outlier_share"] == 0.0
    ok, rows = checks.judge({"a": 0.1, "x": float("nan")}, {"a": 0.2, "x": 1.0})
    assert not ok and rows[0] == ("a", 0.1, 0.2)


@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_agrees_with_every_triangle_tested(any_hit, width):
    inp = scenes.courtyard(2000, seed=3)
    tree = bvh.build(inp.vertices, inp.faces, width=width, leaf=8)
    v = torch.from_numpy(inp.vertices)
    f = torch.from_numpy(inp.faces.astype(np.int64))
    g = torch.Generator().manual_seed(0)
    o = (torch.rand((512, 3), generator=g) - 0.5) * torch.tensor([30.0, 6.0, 30.0])
    o[:, 1] += 4.0
    d = torch.nn.functional.normalize(torch.randn((512, 3), generator=g), dim=1)
    far = torch.full((512,), 10.0 if any_hit else 3e38)
    w = bvh.walk(tree, o, d, far, any_hit=any_hit)
    v0 = v[f[:, 0]]
    t = bvh.triangle_test(o[:, None], d[:, None], v0[None], (v[f[:, 1]] - v0)[None],
                          (v[f[:, 2]] - v0)[None], far[:, None])
    best = t.min(dim=1).values
    hit = torch.isfinite(best)
    assert torch.equal(w.tri >= 0, hit)
    if not any_hit:
        assert torch.equal(w.t[hit], best[hit])
    assert w.inner > 0 and w.tests > 0 and w.inner < w.slots <= width * w.inner
    assert tree.count.sum() == inp.faces.shape[0] and int(tree.count.max()) <= 8


@pytest.mark.parametrize("width", [2, 4, 8])
def test_tree_holds_every_triangle_once_in_boxes_that_nest(width):
    inp = scenes.courtyard(3000, seed=4)
    tree = bvh.build(inp.vertices, inp.faces, width=width, leaf=8)
    assert sorted(tree.tri.tolist()) == list(range(inp.faces.shape[0]))
    inner = torch.nonzero(tree.count == 0)[:, 0]
    assert tree.child.shape[1] == width and bool((tree.child[inner] >= 0).sum(1).ge(2).all())
    for k in range(width):
        ch = tree.child[inner, k]
        m = ch >= 0
        assert bool((tree.lo[ch[m]] >= tree.lo[inner[m]]).all())
        assert bool((tree.hi[ch[m]] <= tree.hi[inner[m]]).all())
    leaves = torch.nonzero(tree.count > 0)[:, 0]
    for n in leaves[:200].tolist():
        s, c = int(tree.start[n]), int(tree.count[n])
        tv = torch.from_numpy(inp.vertices[inp.faces[tree.tri[s:s + c].numpy()]])
        assert bool((tv.amin(dim=(0, 1)) >= tree.lo[n]).all())
        assert bool((tv.amax(dim=(0, 1)) <= tree.hi[n]).all())


def test_sah_tree_beats_a_median_split():
    """The surface-area heuristic's expected cost, summed over the tree
    (an inner node's area per child slot, a leaf's per triangle), lies below
    that of the same tree halved at the median: the split is chosen, not
    fixed."""
    inp = scenes.courtyard(6000, seed=5)
    tree = bvh.build(inp.vertices, inp.faces, width=2, leaf=8)

    def cost(lo, hi, child, count):
        e = (hi - lo).clamp(min=0)
        a = e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]
        return float((a * torch.where(count > 0, count * 2.0, (child >= 0).sum(1) * 1.0)).sum())

    v = np.asarray(inp.vertices, np.float32)[inp.faces]
    tmin, tmax = v.min(1), v.max(1)
    cen = (tmin + tmax) / 2
    lo, hi = [], []

    def median(ix, out_lo, out_hi):      # the median split's boxes and leaf sizes
        out_lo.append(tmin[ix].min(0))
        out_hi.append(tmax[ix].max(0))
        if len(ix) <= 8:
            return [len(ix)]
        ax = int(np.argmax(np.ptp(cen[ix], 0)))
        ix = ix[np.argsort(cen[ix, ax], kind="stable")]
        return [0] + median(ix[:len(ix) // 2], out_lo, out_hi) + median(ix[len(ix) // 2:],
                                                                       out_lo, out_hi)
    counts = torch.tensor(median(np.arange(len(cen)), lo, hi))
    two = torch.where(counts > 0, -1, 0)[:, None].expand(-1, 2)
    med = cost(torch.from_numpy(np.array(lo)), torch.from_numpy(np.array(hi)), two, counts)
    assert cost(tree.lo, tree.hi, tree.child, tree.count) < 0.9 * med


@pytest.mark.parametrize("shape,iterations", [((48, 72), 3), ((520, 40), 4)])
def test_plain_filter_is_the_programs_to_rounding(shape, iterations):
    """reference.atrous, tap after tap, against the program's stacked
    atrous_denoise on a G-buffer of flat patches with misses: the same to
    rounding (1e-5 of the colour's scale), the strided depth scale included
    (520 rows take every second one). test_bench_imports holds that the
    reference loads nothing of the program."""
    from benchmark import reference
    from gpu_raytracer_tpu_torch.ops.denoise import atrous_denoise

    H, W = shape
    g = torch.Generator().manual_seed(iterations)
    n = torch.nn.functional.normalize(torch.randn(H // 8 + 1, W // 8 + 1, 3, generator=g), dim=-1)
    n = n.repeat_interleave(8, 0).repeat_interleave(8, 1)[:H, :W].contiguous()
    miss = torch.rand(H, W, generator=g) < 0.1
    n[miss] = 0.0
    depth = torch.rand(H, W, generator=g) * 0.2 + 4.0
    depth[miss] = 3.4e38
    albedo = torch.rand(H, W, 3, generator=g)
    color = torch.rand(H, W, 3, generator=g) * 2.0
    want = atrous_denoise(color, n, depth, albedo, iterations=iterations)
    got = reference.atrous(color, n, depth, albedo, iterations)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # one pass fewer is another filter
    assert float((reference.atrous(color, n, depth, albedo, iterations - 1) - want)
                 .abs().max()) > 1e-2
