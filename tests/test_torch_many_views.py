"""PyTorch port on a rig of many views (the Middlebury temple's hemisphere,
``benchmark/scenes/hemisphere_object.py``), on the CPU at a tiny size:
K1's shared memory follows the cameras a block holds, not the rig, and
names the largest radius that fits; the refine's
scores of seeded patches on a 40-camera rig agree with the benchmark's
plain float64 reference (``benchmark/reference/photo.py``), and a
bfloat16 reference does not; the many-view comparison's admissible states
stay bounded at 312 cameras and hold the written state; the renderer
keeps the object whole in every frame; the refine's camera counters and
the two metrics that read them, and the rows K1 samples twice."""

import os
import re
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import scenes  # noqa: E402
from benchmark.metrics import (cams_per_row, k1_device_s,  # noqa: E402
                               k1_tiled_share)
from benchmark.reference import check_many_views as CM  # noqa: E402
from benchmark.reference.photo import RefScene, engine_params  # noqa: E402
from benchmark.scenes import hemisphere_object as HO  # noqa: E402
from pais_mvs_tpu_torch.config import MvsConfig  # noqa: E402
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor  # noqa
from pais_mvs_tpu_torch.models import patch as tpm  # noqa: E402
from pais_mvs_tpu_torch.models.camera import CameraParams  # noqa: E402
from pais_mvs_tpu_torch.ops import cuda_fitness as CF  # noqa: E402
from pais_mvs_tpu_torch.ops import lifecycle as tlc  # noqa: E402
from pais_mvs_tpu_torch.trace import Trace  # noqa: E402

BIG = 1e20
KW = dict(patch_radius=3, max_lod=3, particle_num=4, max_iteration=4,
          dist_weighting=1.0, cell_size=2, seed_refine_rounds=1,
          batch_size=64)


def hemisphere_rig(cameras, width, height, seeds, device="cpu"):
    """The hemisphere scene at this size (focal in proportion to the
    temple's 1520 px at 640) and the port's cameras of it."""
    cfg = {"width": width, "height": height, "cameras": cameras,
           "focal": 1520.0 * width / 640, "seeds": seeds, "scene_seed": 11,
           "config_txt": {}}
    sc = HO.render(cfg, 1, device)
    params = [CameraParams(file_name=c.name, focal=np.array([c.focal] * 2),
                           principal=np.array([-1.0, -1.0]),
                           quaternion=np.asarray(c.quaternion),
                           center=np.asarray(c.center)) for c in sc.cameras]
    return cfg, sc, params


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """40 cameras at 96x72, written out as the CLI reads it, and the
    port's Reconstructor of it."""
    cfg, sc, params = hemisphere_rig(40, 96, 72, 16)
    cfg["config_txt"] = {"patchRadius": 3, "distWeighting": 1.0,
                         "maxLOD": 3}
    out = str(tmp_path_factory.mktemp("hemisphere"))
    scenes.write_files(sc, cfg, out)
    rec = Reconstructor(params, sc.images, MvsConfig(**KW), verbose=False,
                        device="cpu")
    return cfg, sc, out, rec


@pytest.mark.parametrize("cameras", [8, 32, 33, 161, 312])
def test_fitness_smem_follows_the_tile(cameras):
    """A block holds the cameras of its rig up to ``CAMERA_SPAN``: any rig
    fits at r = 15, a rig of at most a tile takes what it always took
    (four blocks of eight particles resident per SM), and a wider one
    keeps the blocks of ``WIDE_WARPS`` particles resident that the source
    promises (``kWideBlocks``)."""
    smem = CF.fitness_smem_bytes(cameras, 15)
    assert smem <= CF.SMEM_PER_BLOCK
    old = (8 * 12 + 256 + 3) * 4 * cameras + 4 * 31 ** 2
    if cameras <= CF.CAMERA_TILE:
        assert smem == old
        assert 4 * (smem + 1024) <= 228 * 1024
    else:
        held = min(cameras, CF.CAMERA_SPAN)
        assert smem == (CF.WIDE_WARPS * 44 + 3) * 4 * held + 4 * 31 ** 2
    if cameras == 8:
        assert smem == 15204
    src = open(os.path.join(ROOT, "pais_mvs_tpu_torch", "csrc",
                            "fitness.cu")).read()
    for name, value in (("kTile", CF.CAMERA_TILE),
                        ("kSpan", CF.CAMERA_SPAN),
                        ("kWideWarps", CF.WIDE_WARPS)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(
            1) == str(value)
    # the wider rig's blocks stay as resident as the source promises
    blocks = int(re.search(r"constexpr int kWideBlocks = (\d+);",
                           src).group(1))
    assert blocks == 4
    if cameras > CF.CAMERA_TILE:
        assert blocks * (smem + 1024) <= 228 * 1024


def test_only_k1_kernels_are_named_fitness_kernel():
    """``k1_device_s`` sums the profiler's kernels whose names hold
    ``fitness_kernel``: of every ``__global__`` kernel in the port's
    sources only K1's do, so the refine's geometry kernel, which runs
    beside K1 in every PSO step, is not billed to K1."""
    csrc = os.path.join(ROOT, "pais_mvs_tpu_torch", "csrc")
    kernels = {}
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            src = open(os.path.join(csrc, f)).read()
            for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                   r"\([^()]*\)\s*)?(\w+)\s*\(", src):
                kernels[name] = f
    assert kernels["patch_geometry_kernel"] == "fitness.cu"
    assert {k: f for k, f in kernels.items() if "fitness_kernel" in k} == \
        {"fitness_kernel": "fitness.cu"}
    # as the profiler names them: K1's two instances and the rest
    names = ["void (anonymous namespace)::fitness_kernel<true>(int)",
             "void (anonymous namespace)::fitness_kernel<false>(int)"] + [
        f"void (anonymous namespace)::{k}(int)" for k in kernels
        if k != "fitness_kernel"]
    run = types.SimpleNamespace(profile={"kernel_s": dict.fromkeys(names,
                                                                   1.0)})
    assert k1_device_s.read(run) == 2.0


def test_fitness_max_radius_names_the_limit():
    """The largest radius whose block fits, on each side of the tile and
    the span: r = 107 on a rig of 32 cameras, 113 on one of 33 (four
    particles a block), 105 on any rig of ``CAMERA_SPAN`` cameras or
    more."""
    for cameras, r in ((8, 117), (32, 107), (33, 113), (CF.CAMERA_SPAN, 105),
                       (CF.CAMERA_SPAN + 1, 105), (312, 105)):
        assert CF.fitness_max_radius(cameras) == r
        assert CF.fitness_smem_bytes(cameras, r) <= CF.SMEM_PER_BLOCK
        assert CF.fitness_smem_bytes(cameras, r + 1) > CF.SMEM_PER_BLOCK


def test_refine_agrees_with_reference(rig):
    """One seed round of the port's refine on the CPU, scored again by the
    plain reference in float64 under the state the round used (its input
    cameras, reference camera and level) at the round's answer.

    Tolerances: the fitness to 2e-4 relative and the correlation to 2e-6:
    the port computes in float32 and the reference in float64 on the same
    8-bit levels, which leaves gaps of 2.5e-5 and 1.3e-7 at most over
    these patches; the reference in bfloat16 misses them by 0.8 and 1e-2.
    """
    cfg, sc, out, rec = rig
    scene, tcfg = rec.scene, rec.cfg
    pb = tlc.prepare_seeds(scene, tcfg, tpm.from_seeds(
        sc.seed_points, sc.seed_masks, sc.seed_pixels, device="cpu"))
    ref_cam = tlc.set_reference_camera(scene, pb.normal(), pb.cam_mask)
    lod = tlc.set_lod(scene, tcfg, pb.center, ref_cam)
    res = tlc.refine_batch(scene, tcfg, pb, 0.05, True, 1,
                           final_filter=False,
                           generator=torch.Generator().manual_seed(3))
    b = res.batch
    ok = (b.valid & (b.fitness < BIG)).numpy()
    assert ok.sum() >= 4
    params = engine_params(cfg["config_txt"])
    f64 = lambda t: t.to(torch.float64)[ok]
    state = (ref_cam.long()[ok], pb.cam_mask[ok], lod.long()[ok])
    gaps = {}
    for name, dtype in (("float64", torch.float64),
                        ("bfloat16", torch.bfloat16)):
        ref = RefScene(out, sc.cameras, params, "cpu", dtype=dtype)
        c, n = f64(b.center).to(dtype), f64(b.normal()).to(dtype)
        fit = ref.fitness(c[:, None], n, *state)[:, 0].numpy()
        corr = ref.correlation(c, n, *state)[0].numpy()
        gaps[name] = (np.abs(b.fitness.numpy()[ok] - fit) / fit,
                      np.abs(b.correlation.numpy()[ok] - corr))
    fit_gap, corr_gap = gaps["float64"]
    assert fit_gap.max() < 2e-4 and corr_gap.max() < 2e-6, gaps["float64"]
    fit_gap, corr_gap = gaps["bfloat16"]
    assert fit_gap.max() > 2e-4 and corr_gap.max() > 2e-6


def _temple_rig():
    """The 312 cameras of the temple's hemisphere at 640x480 as the
    comparison holds them (``RefScene``'s fields that ``states`` reads)."""
    C = 312
    centers = HO.camera_centers(C, 10.7)
    R = np.stack([HO.lookat(c) for c in centers])
    t = torch.as_tensor
    return types.SimpleNamespace(
        optical=t(R[:, 2, :]), Rt=t(R), Ct=t(centers),
        ft=torch.full((C,), 1520.0, dtype=torch.float64),
        ppt=t(np.tile([320.0, 240.0], (C, 1))), dev=torch.device("cpu"),
        max_lod=[4] * C,
        lod=lambda c, r: torch.full((len(r),), 2, dtype=torch.long))


def _child(ref, c, n, mask, view, step, cell=4.0, move=0.01):
    """An expansion patch of the patch (c, n, mask) as the program makes
    one: the ray through the centre of the cell ``step`` from the parent's
    in camera ``view`` met with the parent's plane, then moved ``move``
    along the line from the reference camera of the parent's expansion
    set -> (centre, expansion set, reference camera)."""
    cams = tuple(a.numpy() for a in (ref.Rt, ref.Ct, ref.ft, ref.ppt))
    face = n @ -ref.optical.numpy().T
    E = CM.expansion_set(face[None], mask[None], 0.7, 3)[0]
    r = int(np.argmax(np.where(E, face, -np.inf)))
    pk = CM.project(cams, c[None])[0][0, view]
    px = (np.floor(pk / cell) + step + 0.5) * cell
    R, C, f, pp = (a[view] for a in cams)
    d = R.T @ np.array([(px[0] - pp[0]) / f, (px[1] - pp[1]) / f, 1.0])
    X0 = C + d * (n @ (c - C)) / (n @ d)
    ray = (X0 - cams[1][r]) / np.linalg.norm(X0 - cams[1][r])
    return X0 + move * ray, E, r


def test_check_states_bounded_at_312_cameras():
    """The many-view comparison's states of patches on the 312-camera
    hemisphere: a few hundred a patch at most (not the ~60,000 of
    ``check.states``); among them the written set under its best
    reference camera, and for an expansion patch its parent's expansion
    set under that set's reference, and no state of another patch."""
    ref = _temple_rig()
    C = 312
    rng = np.random.default_rng(5)
    d = rng.normal(size=(200, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * HO.radius_at(d)[:, None]
    face = d @ -ref.optical.numpy().T
    # written sets: the cone less a few cameras, as the refine leaves them
    masks = (face >= 0.7) & (rng.random((200, C)) > 0.2)
    assert masks.sum(1).max() > 40
    # patch 8: a child of patch 0 (by the 4-neighbour cell to the right of
    # patch 0's in one of its views), its set the parent's less a camera
    view = int(np.nonzero(masks[0])[0][3])
    pts[8], E, r = _child(ref, pts[0], d[0], masks[0], view, (1, 0))
    d[8], face[8] = d[0], face[0]
    masks[8] = E
    masks[8, np.nonzero(E)[0][-1]] = False
    sph = np.stack([np.arccos(d[:, 2]), np.arctan2(d[:, 1], d[:, 0])], -1)
    from benchmark.reference.mvsfile import Cloud
    cloud = Cloud(pts, sph, masks, np.ones(200), np.ones(200))
    idx = np.arange(9)
    t = lambda a: torch.as_tensor(a[idx])
    pi, rc, mk, lv = CM.states(ref, t(pts), t(d), t(masks), [cloud] * 9,
                               0.7, 3, 4.0)
    per = np.bincount(pi.numpy(), minlength=9)
    assert per.max() <= 3 * (CM.TOP_REFS + C // 3 + 2)
    assert per.max() < 1000 and per.min() > 0
    for i in idx:
        rows = (pi == int(i)).numpy()
        best = int(np.argmax(np.where(masks[i], face[i], -np.inf)))
        hit = rows & (rc.numpy() == best) & (mk.numpy() == masks[i]).all(1)
        assert hit.sum() == 3           # its level and the two beside it
    child = (pi == 8).numpy()
    parent = child & (rc.numpy() == r) & (mk.numpy() == E).all(1)
    assert parent.sum() == 3
    # patch 0's own expansion set is no state of patch 0 (it has no parent
    # among the others), nor of the other random patches
    for i in range(8):
        rows = (pi == i).numpy()
        Ei = CM.expansion_set(face[i][None], masks[i][None], 0.7, 3)[0]
        own = (mk.numpy()[rows] == Ei).all(1) & (Ei != masks[i]).any()
        assert not own.any()


@pytest.mark.parametrize("step,move,made", [
    ((1, 0), 0.0, True), ((0, -1), 0.02, True), ((0, 1), -0.01, True),
    ((1, 1), 0.0, False), ((2, 0), 0.0, False), ((0, 0), 0.0, False)])
def test_parent_test(step, move, made):
    """``parents``: a patch made from a 4-neighbour cell of its parent's,
    anywhere along its reference ray, passes; a diagonal, farther or the
    same cell does not, nor a point a tenth of a pixel off the cell's
    centre."""
    ref = _temple_rig()
    cams = tuple(a.numpy() for a in (ref.Rt, ref.Ct, ref.ft, ref.ppt))
    n = np.array([0.3, -0.2, 0.9])
    n /= np.linalg.norm(n)
    c = n * HO.radius_at(n[None])[0]
    mask = (n @ -ref.optical.numpy().T) >= 0.7
    view = int(np.nonzero(mask)[0][5])
    x, E, r = _child(ref, c, n, mask, view, step, move=move)
    got = CM.parents(cams, x, c[None], n[None], mask[None],
                     np.array([r]), 4.0)
    assert bool(got[0]) == made
    # a tenth of a pixel off the cell's centre in the view it came from
    R = cams[0][view]
    off = x + 0.1 * 10.7 / 1520.0 * R[0]
    assert not CM.parents(cams, off, c[None], n[None],
                          mask[None] & (np.arange(312) == view),
                          np.array([r]), 4.0)[0]


def test_renderer_keeps_the_object_in_every_frame(monkeypatch):
    """Every frame's border rows and columns are background, the object
    is never 0 where it is seen, and a rig too close to the object is
    refused."""
    cfg, sc, _ = hemisphere_rig(24, 64, 48, 8)
    im = np.stack(sc.images)[..., 0]
    e = HO.EDGE
    assert not im[:, :e].any() and not im[:, -e:].any()
    assert not im[:, :, :e].any() and not im[:, :, -e:].any()
    fg = (im > 0).mean(axis=(1, 2))
    assert fg.min() > 0.2
    assert len(sc.seed_points) > 0 and sc.seed_masks.sum(1).min() >= 3
    monkeypatch.setattr(HO, "FILL", 1.1)
    with pytest.raises(AssertionError, match="leaves a frame"):
        HO.render(cfg, 1)


def test_camera_counters_and_their_metrics(rig):
    """The seeds' and candidates' cameras, counted from the host's masks
    as the refine receives them, and the metrics that read the counters
    (None for a program without them)."""
    cfg, sc, out, rec = rig
    rec.load_seeds(sc.seed_points, sc.seed_masks, sc.seed_pixels)
    rec.refine_seeds()
    rec.expand(max_rounds=1)
    c = rec.trace.summary()["counters"]
    assert c["scored_cams"] >= sc.seed_masks.sum()
    assert c["refined_rows"] >= len(sc.seed_points)
    assert 0 <= c["k1_tiled_rows"] <= c["refined_rows"]
    assert 0 <= c["k1_resampled_rows"] <= c["k1_tiled_rows"]

    tr = Trace()
    fake = types.SimpleNamespace(trace=tr)
    masks = np.zeros((3, 80), bool)
    masks[0, :5] = masks[1, :40] = masks[2, :33] = True
    Reconstructor._count_cams(fake, masks)
    assert tr.counters == {"scored_cams": 78, "k1_tiled_rows": 2,
                           "k1_resampled_rows": 0}
    # rows on both sides of the tile and of the span
    span = CF.CAMERA_SPAN
    seen = (32, 33, span, span + 1)
    masks = np.zeros((len(seen), 2 * span), bool)
    for row, n in zip(masks, seen):
        row[np.random.default_rng(n).permutation(2 * span)[:n]] = True
    tr = Trace()
    Reconstructor._count_cams(types.SimpleNamespace(trace=tr), masks)
    assert tr.counters == {"scored_cams": sum(seen), "k1_tiled_rows": 3,
                           "k1_resampled_rows": 1}

    def job(counters):
        trace = {"spans": {}, "counters": counters, "rounds": []}
        return {"stats": {"trace": trace}}

    run = types.SimpleNamespace(jobs=[
        job({"scored_cams": 300, "k1_tiled_rows": 50, "refined_rows": 100}),
        job({"scored_cams": 100, "k1_tiled_rows": 0, "refined_rows": 50})])
    assert cams_per_row.read(run) == pytest.approx((3.0 + 2.0) / 2)
    assert k1_tiled_share.read(run) == pytest.approx((50.0 + 0.0) / 2)
    parent = types.SimpleNamespace(jobs=[job({"refined_rows": 100})])
    assert cams_per_row.read(parent) is None
    assert k1_tiled_share.read(parent) is None
    untraced = types.SimpleNamespace(jobs=[{"stats": {}}])
    assert cams_per_row.read(untraced) is None
    assert k1_tiled_share.read(untraced) is None
