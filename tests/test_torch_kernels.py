"""PyTorch port: the CUDA kernels against their plain PyTorch twins, on the
card. Marked ``gpu``; without a CUDA device every test skips.

This file imports neither JAX nor ``pais_mvs_tpu`` and uses no conftest
fixture, so it also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Tolerances: K1's BIG set exactly, values to 1e-4 (relative above 1): the
per-pixel terms round alike (the kernels build with --fmad=false) and only
the window sum's order differs; K1 is checked at every particle-tile
remainder (P in {1, 7, 16, 30}), on a 12-camera rig, and on
hemisphere rigs of 8, 12, 161 and 312 cameras (``benchmark/scenes/
hemisphere_object.py``) with rows past K1's camera tile and rows of
exactly 33, ``CAMERA_SPAN``, ``CAMERA_SPAN`` + 1, ``RESIDENT`` and
``RESIDENT`` + 1 cameras, whose rows
within the tile are bit-equal to the same rows on a rig of only the
tile's cameras (the launch of a rig of at most a tile); K2's ok set
exactly, samples to 1e-5; the view fitness's kernels (view_moments,
view_deviation): counts and reference planes equal, camera sums and
deviations to 1e-5 (relative above 1), on camera blocks of 1, 5 and 12;
M to 1e-4 relative (the kernels sum the particles in the plain version's
order), and its variants (c) and (d) bit-equal to (a); the refine replayed from its CUDA graph bit-equal to the eager
refine on the same draws (also on the 312-camera rig); a 312-camera
``-r`` job through the CLI; the scene build's kernels (csrc/pyramid.cu) and
``build_scene`` on the card bit-equal to their plain twins.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.data.realistic import make_realistic_scene
from pais_mvs_tpu_torch.data.synthetic import make_scene
from pais_mvs_tpu_torch.models import patch as tpm
from pais_mvs_tpu_torch.models.camera import build_scene
from pais_mvs_tpu_torch.ops import cuda_fitness as CF
from pais_mvs_tpu_torch.ops import fitness as TF
from pais_mvs_tpu_torch.ops.graphs import RefineGraphs
from pais_mvs_tpu_torch.ops import lifecycle as tlc
from pais_mvs_tpu_torch.ops import view_fitness as VF
from pais_mvs_tpu_torch.tools import microbench_kernel as MB

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_many_views import hemisphere_rig  # noqa: E402

BIG = 1e20
KW = dict(patch_radius=5, max_lod=4, particle_num=8, max_iteration=12,
          batch_size=64, dist_weighting=5.0 / 3.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    CF.build_kernels()
    return torch.device("cuda")


def _problem(device, num_cams, num_seeds, P=16):
    """Seeds of a small synthetic scene with bench.py's wide hypothesis
    noise (P particles per seed)."""
    sc = make_scene(num_cams=num_cams, width=200, height=150,
                    num_seeds=num_seeds)
    cfg = MvsConfig(**KW)
    scene = build_scene(sc.params, sc.images, cfg, device=device)
    pb = tlc.prepare_seeds(scene, cfg, tpm.from_seeds(
        sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
        device=device))
    normal = pb.normal()
    ref = tlc.set_reference_camera(scene, normal, pb.cam_mask)
    depth, ray = tlc.set_depth_and_ray(scene, pb.center, ref)
    lod = tlc.set_lod(scene, cfg, pb.center, ref)
    return scene, pb, normal, ref, lod, ray, _hypotheses(pb, depth, P)


def _hypotheses(pb, depth, P, seed=7):
    rng = np.random.default_rng(seed)
    noise = torch.tensor(rng.normal(size=(pb.capacity, P, 3))
                         * np.array([0.3, 0.3, 0.002]), dtype=torch.float32,
                         device=depth.device)
    return torch.stack([pb.normal_sph[:, 0], pb.normal_sph[:, 1], depth],
                       -1)[:, None, :] + noise


@pytest.fixture(scope="module")
def problem(cuda):
    return _problem(cuda, 5, 40)


@pytest.fixture(scope="module")
def problem12(cuda):
    """A 12-camera rig: more cameras than the kernel's first form took."""
    return _problem(cuda, 12, 40)


def _fitness_both(problem, radius, pos=None, active=None, pvalid=None):
    """(plain, kernel) fitness at ``radius`` on the problem's seeds."""
    scene, pb, _, ref, lod, ray, pos0 = problem
    cfg = MvsConfig(**{**KW, "patch_radius": radius,
                       "dist_weighting": radius / 3.0})
    H, pt, pv = TF.fitness_geometry(scene, cfg, ref, pb.cam_mask, lod, ray,
                                    pos0 if pos is None else pos)
    args = (scene.pyramids, cfg, H, pt, ref, pb.cam_mask, lod,
            pv if pvalid is None else pvalid)
    return (TF.score_windows(*args).cpu().numpy(),
            CF.score_windows(*args, active).cpu().numpy())


def _assert_fitness_match(a, b):
    np.testing.assert_array_equal(a >= BIG, b >= BIG)
    ok = a < BIG
    assert ok.any()
    np.testing.assert_allclose(b[ok], a[ok], rtol=1e-4, atol=1e-4)


def _hemisphere_problem(device, num_cams, P=16):
    """Seeds of the hemisphere rig of ``num_cams`` cameras at 320x240, each
    in the views that see it (up to ~30% of the rig), as ``_problem``."""
    _, sc, params = hemisphere_rig(num_cams, 320, 240, 48, device)
    cfg = MvsConfig(**KW)
    scene = build_scene(params, sc.images, cfg, device=device)
    pb = tlc.prepare_seeds(scene, cfg, tpm.from_seeds(
        sc.seed_points, sc.seed_masks, sc.seed_pixels, device=device))
    normal = pb.normal()
    ref = tlc.set_reference_camera(scene, normal, pb.cam_mask)
    depth, ray = tlc.set_depth_and_ray(scene, pb.center, ref)
    lod = tlc.set_lod(scene, cfg, pb.center, ref)
    return scene, pb, normal, ref, lod, ray, _hypotheses(pb, depth, P)


@pytest.fixture(scope="module")
def hemispheres(cuda):
    return {C: _hemisphere_problem(cuda, C) for C in (8, 12, 161, 312)}


def _with_mask(problem, mask):
    """``problem`` with every row seeing ``mask`` [B, C] (reference
    camera and level set again)."""
    scene, pb, normal, _, _, _, pos = problem
    pb = pb.replace(cam_mask=mask)
    cfg = MvsConfig(**KW)
    ref = tlc.set_reference_camera(scene, normal, mask)
    _, ray = tlc.set_depth_and_ray(scene, pb.center, ref)
    lod = tlc.set_lod(scene, cfg, pb.center, ref)
    return scene, pb, normal, ref, lod, ray, pos


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [6, 15])
@pytest.mark.parametrize("C", [8, 12, 161, 312])
@pytest.mark.parametrize("seen", ["seeds", "all"])
def test_fitness_kernel_many_cameras(hemispheres, C, radius, seen):
    """K1 against the plain twin on hemisphere rigs: each seed in the
    views that see it (up to ~90 of 312, past the camera tile), and every
    row seeing the whole rig (161 and 312 cameras a row, five tiles and
    more, with the far side's views in frame too)."""
    problem = hemispheres[C]
    if seen == "all":
        pb = problem[1]
        problem = _with_mask(problem, torch.ones_like(pb.cam_mask))
    counts = problem[1].cam_mask.sum(1)
    if C > CF.CAMERA_TILE:
        assert int(counts.max()) > CF.CAMERA_TILE
    a, b = _fitness_both(problem, radius)
    _assert_fitness_match(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [6, 15])
def test_fitness_kernel_rows_within_tile_are_single_pass(hemispheres,
                                                         radius):
    """Rows that see at most a tile of cameras on the 312-camera rig score
    bit-equal to the same rows on a rig of only those cameras, whose
    launch (shared memory, one pass) is that of a rig of at most a tile."""
    scene, pb, normal, _, _, _, pos = hemispheres[312]
    counts = pb.cam_mask.sum(0)
    tile = torch.sort(torch.argsort(counts, descending=True)[
        :CF.CAMERA_TILE]).values
    keep = torch.zeros_like(pb.cam_mask[0])
    keep[tile] = True
    mask = pb.cam_mask & keep
    rows = mask.sum(1) >= 3
    problem = _with_mask(hemispheres[312], mask)
    _, _, _, ref, lod, ray, _ = problem
    cfg = MvsConfig(**{**KW, "patch_radius": radius,
                       "dist_weighting": radius / 3.0})
    H, pt, pv = TF.fitness_geometry(scene, cfg, ref, mask, lod, ray, pos)
    wide = CF.score_windows(scene.pyramids, cfg, H, pt, ref, mask, lod, pv)
    p = scene.pyramids
    sub = dataclasses.replace(
        p, images=p.images[tile].contiguous(),
        edges=p.edges[tile].contiguous(), dims=p.dims[tile].contiguous(),
        rgb=p.rgb[tile], var=p.var[tile])
    pos_in_tile = torch.searchsorted(tile, ref.long()).to(torch.int32)
    narrow = CF.score_windows(sub, cfg, H[:, :, tile].contiguous(), pt,
                              pos_in_tile, mask[:, tile].contiguous(), lod,
                              pv)
    assert int(rows.sum()) > 8
    assert torch.equal(wide[rows], narrow[rows])
    assert (wide[rows] < BIG).any()


# the widest row whose records all stay in a wide block's shared memory
# beside the samples of one camera (12 + 32 floats a camera of the span)
RESIDENT = (44 * CF.CAMERA_SPAN - 32) // 12


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [6, 15])
@pytest.mark.parametrize("seen", [CF.CAMERA_TILE + 1, CF.CAMERA_SPAN,
                                  CF.CAMERA_SPAN + 1, RESIDENT,
                                  RESIDENT + 1])
def test_fitness_kernel_rows_at_the_span(hemispheres, seen, radius):
    """Every row of the 312-camera rig seeing exactly ``seen`` cameras, the
    ones that best face it: just past the tile and a whole span (one pass),
    one camera past the span (its records resident, the first camera
    sampled again), the widest row whose records stay resident (the
    samples of one camera kept) and one camera more (tiles of records),
    against the plain twin."""
    scene, pb, normal = hemispheres[312][:3]
    top = torch.topk(-(normal @ scene.rig.optical.T), seen, dim=1).indices
    mask = torch.zeros_like(pb.cam_mask).scatter_(1, top, True)
    problem = _with_mask(hemispheres[312], mask)
    assert bool((problem[1].cam_mask.sum(1) == seen).all())
    a, b = _fitness_both(problem, radius)
    _assert_fitness_match(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [3, 6, 15, 24])
def test_fitness_kernel_matches_plain(problem, radius):
    before = CF.LAUNCHES["fitness"]
    a, b = _fitness_both(problem, radius)
    assert CF.LAUNCHES["fitness"] == before + 1
    _assert_fitness_match(a, b)
    # inactive swarms come back BIG, active ones unchanged
    pos = problem[-1]
    act = torch.arange(pos.shape[0], device=pos.device) % 2 == 0
    _, c = _fitness_both(problem, radius, active=act)
    am = act.cpu().numpy()
    np.testing.assert_array_equal(c[am], b[am])
    assert np.all(c[~am] >= BIG)


@pytest.mark.gpu
@pytest.mark.parametrize("P,radius", [(1, 15), (7, 3), (7, 15), (30, 6),
                                      (30, 24)])
def test_fitness_kernel_particle_tiles(problem, P, radius):
    """Eight particles a block: one particle, a partial tile (7, 30 = 3 x 8
    + 6) and several tiles, at small and large windows."""
    scene, pb, _, ref, _, _, _ = problem
    depth, _ = tlc.set_depth_and_ray(scene, pb.center, ref)
    a, b = _fitness_both(problem, radius, _hypotheses(pb, depth, P, seed=P))
    _assert_fitness_match(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("P,radius", [(7, 3), (16, 6), (7, 15), (16, 24)])
def test_fitness_kernel_twelve_cameras(problem12, P, radius):
    scene, pb, _, ref, _, _, _ = problem12
    assert int(pb.cam_mask.sum(1).max()) > 8
    depth, _ = tlc.set_depth_and_ray(scene, pb.center, ref)
    a, b = _fitness_both(problem12, radius,
                         _hypotheses(pb, depth, P, seed=P))
    _assert_fitness_match(a, b)


@pytest.mark.gpu
def test_fitness_kernel_dead_batches(problem):
    """An all-inactive batch and a batch with no valid particle come back
    all BIG."""
    B, P = problem[-1].shape[:2]
    dev = problem[-1].device
    _, b = _fitness_both(problem, 15,
                         active=torch.zeros(B, dtype=torch.bool, device=dev))
    assert np.all(b >= BIG)
    _, b = _fitness_both(problem, 15,
                         pvalid=torch.zeros((B, P), dtype=torch.bool,
                                            device=dev))
    assert np.all(b >= BIG)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [3, 5, 6, 15, 24])
def test_sampler_kernel_matches_plain(problem, radius):
    scene, pb, normal, ref, lod, _, _ = problem
    cfg = MvsConfig(**{**KW, "patch_radius": radius})
    mask = pb.cam_mask.clone()
    mask[::3, 1] = False                       # masked cameras -> INVALID
    center = pb.center + 0.02                  # some windows leave frame
    H, _, pt = TF.warp_geometry(scene, cfg, center, normal, ref, lod)
    a = TF.warped_samples(scene.pyramids, H, pt, lod, mask,
                          radius).cpu().numpy()
    b = CF.warped_samples(scene.pyramids, H, pt, lod, mask,
                          radius).cpu().numpy()
    np.testing.assert_array_equal(a > -5e8, b > -5e8)
    assert (a > -5e8).mean() > 0.3
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    # a batch with every camera masked is INVALID throughout
    b = CF.warped_samples(scene.pyramids, H, pt, lod, torch.zeros_like(mask),
                          radius).cpu().numpy()
    assert np.all(b == np.float32(TF.INVALID))


@pytest.fixture(scope="module")
def problem_real(cuda):
    """The real-photo pawn-rig scene (5 cameras), its seeds prepared."""
    rsc = make_realistic_scene(num_seeds=64, seed=0)
    cfg = MvsConfig(**KW)
    scene = build_scene(rsc.params, rsc.images, cfg, device=cuda)
    pb = tlc.prepare_seeds(scene, cfg, tpm.from_seeds(
        rsc.seed_centers, rsc.seed_cam_masks, rsc.seed_img_points,
        device=cuda))
    ref = tlc.set_reference_camera(scene, pb.normal(), pb.cam_mask)
    depth, ray = tlc.set_depth_and_ray(scene, pb.center, ref)
    lod = tlc.set_lod(scene, cfg, pb.center, ref)
    return scene, pb, pb.normal(), ref, lod, ray, _hypotheses(pb, depth, 16)


def _view_inputs(problem, radius, c, act=None, pvalid=None):
    """The view kernels' inputs on the camera block of size ``c`` holding
    the rig's middle camera: H to the block's cameras, window centres,
    pvalid; act switches one camera of every fourth patch off; every
    third patch's reference camera lies off the block's owner; last, each
    patch's number of visible cameras in the whole rig."""
    scene, pb, _, ref, lod, ray, pos = problem
    C = scene.num_cameras
    cfg = MvsConfig(**{**KW, "patch_radius": radius})
    H, pt, pv = TF.fitness_geometry(scene, cfg, ref, pb.cam_mask, lod, ray,
                                    pos)
    vi = (C // 2) // c
    offset = vi * c
    pyrs = VF._local_pyramids(scene.view_block(vi, C // c).pyramids, offset,
                              c)
    mask = pb.cam_mask[:, offset:offset + c].contiguous()
    if act is None:
        act = mask.clone()
        act[::4, 0] = False
    own, ref_loc = VF.own_and_local(ref, offset, c)
    own = own & (torch.arange(ref.shape[0], device=ref.device) % 3 != 0)
    return (pyrs, H[:, :, offset:offset + c].contiguous(), pt, lod, act,
            mask, pv if pvalid is None else pvalid, ref_loc, own,
            pb.cam_mask.sum(-1).float())


def _view_both(args, radius, edges):
    """(plain, kernel) of view_moments, then of view_deviation against
    the plain sum over the whole rig's visible cameras (as one view rank
    sees it); checks the launches and
    the match: planes 1-3 equal on rows whose window centre is finite (the
    others are never read: their particles are invalid), plane 0 and the
    deviation to 1e-5 (relative above 1). Returns the four as numpy."""
    pyrs, H, pt, lod, act, mask, pvalid, ref_loc, own, cn = args
    before = dict(CF.LAUNCHES)
    a = TF.view_moments(pyrs, H, pt, lod, act, mask, pvalid, ref_loc, own,
                        radius, edges)
    b = CF.view_moments(pyrs, H, pt, lod, act, mask, pvalid, ref_loc, own,
                        radius, edges)
    mean = a[0] / cn.clamp(min=1)[:, None, None]
    da = TF.view_deviation(pyrs, H, pt, lod, act, pvalid, mean, radius)
    db = CF.view_deviation(pyrs, H, pt, lod, act, pvalid, mean, radius)
    assert CF.LAUNCHES == {**before,
                           "view_moments": before["view_moments"] + 1,
                           "view_deviation": before["view_deviation"] + 1}
    W2 = (2 * radius + 1) ** 2
    assert b.shape == (3 + edges, *pt.shape[:2], W2)
    assert db.shape == (*pt.shape[:2], W2)
    a, b, da, db = (t.cpu().numpy() for t in (a, b, da, db))
    rows = torch.isfinite(pt).all(-1).cpu().numpy()
    np.testing.assert_array_equal(b[1:][:, rows], a[1:][:, rows])
    np.testing.assert_allclose(b[0], a[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(db, da, rtol=1e-5, atol=1e-5)
    return a, b, da, db


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [3, 6, 15, 24])
@pytest.mark.parametrize("which,c", [("synthetic", 5), ("synthetic", 1),
                                     ("realistic", 5), ("realistic", 1),
                                     ("twelve", 12)])
def test_view_kernels_match_plain(request, which, c, radius):
    """The view fitness's two kernels (A: view_moments, B: view_deviation)
    against their plain twins on both scenes and the 12-camera rig, on a
    camera block of c = 1, 5 or 12, with act rows off and the reference
    camera owned by some rows only; the edge plane on and off."""
    problem = request.getfixturevalue(
        {"synthetic": "problem", "realistic": "problem_real",
         "twelve": "problem12"}[which])
    args = _view_inputs(problem, radius, c)
    for edges in (False, True):
        a, b, da, db = _view_both(args, radius, edges)
    assert (a[1] > 0).any() and (a[0] != 0).any() and (a[2] != 0).any()
    assert (db != 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("dead", ["act", "pvalid"])
def test_view_kernels_dead_batches(problem, dead):
    """Every swarm inactive, and no valid particle: plane 0 and the
    deviation are 0, plane 1 counts every visible camera of the block."""
    pb = problem[1]
    B, P = problem[-1].shape[:2]
    dev = pb.center.device
    kw = ({"act": torch.zeros((B, 1), dtype=torch.bool, device=dev)}
          if dead == "act" else
          {"pvalid": torch.zeros((B, P), dtype=torch.bool, device=dev)})
    args = _view_inputs(problem, 15, 1, **kw)
    _, b, _, db = _view_both(args, 15, True)
    assert not b[0].any() and not db.any()
    count = args[5].sum(-1).float().cpu().numpy()[:, None, None]
    np.testing.assert_array_equal(b[1], np.broadcast_to(count, b[1].shape))
    assert count.any()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", MB.VARIANTS)
def test_microbench_kernels_match_plain(cuda, variant):
    box = MB.make_box(0, cuda)
    before = CF.LAUNCHES[f"microbench_{variant}"]
    got = MB.run_grid(box, variant=variant)
    assert CF.LAUNCHES[f"microbench_{variant}"] == before + 1
    assert MB.max_rel_err(got, MB.run_grid_plain(box)) <= 1e-4


@pytest.mark.gpu
def test_microbench_footprint_variants_equal_a(cuda):
    """(c) and (d) give (a)'s bits (same arithmetic in the same order, only
    the taps' staging and layout differ), one launch each; (d) also on a
    grid of 3 blocks over 50 cells, so each block walks its ring through
    16-17 cells, and the occupancy grid is a positive multiple of the SMs."""
    box = MB.make_box(0, cuda)
    a = MB.run_grid(box, variant="a")
    for v in ("c", "d"):
        before = CF.LAUNCHES[f"microbench_{v}"]
        assert torch.equal(MB.run_grid(box, variant=v), a)
        assert CF.LAUNCHES[f"microbench_{v}"] == before + 1
    assert torch.equal(MB.run_grid(box, 50, variant="d", grid=3),
                       MB.run_grid(box, 50, variant="a"))
    grid = MB.persistent_grid(MB.tap_footprint(), box.device.index)
    sms = torch.cuda.get_device_properties(box.device).multi_processor_count
    assert grid >= sms and grid % sms == 0


def _pyramid_image(shape, seed, gray=False):
    """A seeded uint8 image with structure and noise (RGB, or one channel)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(x / 7.0 + seed) * np.cos(y / 11.0)
    img = np.clip(base[..., None] + rng.normal(0, 25, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    return np.ascontiguousarray(img[..., 0]) if gray else img


def _same(card: torch.Tensor, cpu: torch.Tensor) -> bool:
    a = card.cpu()
    if a.dtype == torch.bfloat16:
        a, cpu = a.view(torch.int16), cpu.view(torch.int16)
    return a.dtype == cpu.dtype and torch.equal(a, cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ratio,radius,gray", [
    ((97, 131), 0.8, 3, False), ((240, 180), 0.5, 15, False),
    ((61, 1), 0.8, 3, True)])
def test_pyramid_kernels_match_twins(cuda, shape, ratio, radius, gray):
    """Each kernel of csrc/pyramid.cu gives its plain twin's bits on the
    same inputs (the twin on CPU copies of the card's tensors), through
    every level of one image, and launches once per call."""
    from pais_mvs_tpu_torch.ops import pyramid as PY
    img = torch.from_numpy(_pyramid_image(shape, 5, gray))
    h, w = shape
    before = dict(CF.LAUNCHES)
    rgb_c = torch.zeros((h + 2, w + 3, 3), dtype=torch.uint8, device=cuda)
    rgb_h = rgb_c.cpu()
    g = PY.gray_plane(img.to(cuda), rgb_c)
    gh = PY.gray_plane(img, rgb_h)
    assert _same(g, gh) and _same(rgb_c, rgb_h)
    F = PY.antiderivative(g)
    assert _same(F, PY.antiderivative(gh))
    dims = PY.level_dims(h, w, ratio, PY.max_lod_for(w, h, ratio, 8))
    yoff, wa = PY.atlas_offsets([dims], len(dims))
    planes_c = [torch.zeros((int(yoff[-1]), wa), dtype=torch.bfloat16,
                            device=cuda) for _ in range(3)]
    planes_c[2].fill_(-1.0)
    planes_h = [p.cpu() for p in planes_c]
    for l, (lh, lw) in enumerate(dims.tolist()):
        lvl = g
        if l:
            tmp = PY.resample_rows(g, F, lh)
            assert _same(tmp, PY.resample_rows(gh, F.cpu(), lh))
            G = PY.row_antiderivative(tmp)
            assert _same(G, PY.row_antiderivative(tmp.cpu()))
            lvl = PY.resample_cols(tmp, G, lw)
            assert _same(lvl, PY.resample_cols(tmp.cpu(), G.cpu(), lw))
        lohi = PY.edge_range(lvl)
        assert _same(lohi, PY.edge_range(lvl.cpu()))
        M = PY.moment_antiderivative(lvl)
        assert _same(M, PY.moment_antiderivative(lvl.cpu()))
        I = PY.row_antiderivative(M)
        assert _same(I, PY.row_antiderivative(M.cpu()))
        PY.pack_level(lvl, lohi, I, radius, int(yoff[l]), *planes_c)
        PY.pack_level(lvl.cpu(), lohi.cpu(), I.cpu(), radius, int(yoff[l]),
                      *planes_h)
    for pc, ph in zip(planes_c, planes_h):
        assert _same(pc, ph)
    L = len(dims)
    assert {k: CF.LAUNCHES[k] - before[k] for k in CF.LAUNCHES
            if k.startswith("pyramid_")} == {
        "pyramid_gray": 1, "pyramid_col_scan": 1 + L,
        "pyramid_row_scan": 2 * L - 1, "pyramid_resample_rows": L - 1,
        "pyramid_resample_cols": L - 1, "pyramid_edge_range": L,
        "pyramid_pack": L}


@pytest.mark.gpu
def test_build_scene_on_card_equals_cpu(cuda):
    """build_scene on the card (the kernels) against the CPU (the twins):
    every atlas, dims, yoff and the colour plane bit for bit, whole and as
    view blocks, on a rig of mixed sizes with a gray camera."""
    sc = make_scene(num_cams=4, width=200, height=150, num_seeds=8)
    images = list(sc.images)
    images[1] = _pyramid_image((131, 97), 6)
    images[2] = _pyramid_image((150, 200), 7, gray=True)
    for kw in (dict(patch_radius=5, max_lod=4),
               dict(patch_radius=15, max_lod=8, lod_ratio=0.5)):
        cfg = MvsConfig(**kw)
        for vb in (None, (1, 2)):
            card = build_scene(sc.params, images, cfg, device=cuda,
                               view_block=vb)
            cpu = build_scene(sc.params, images, cfg, device="cpu",
                              view_block=vb)
            for f in dataclasses.fields(cpu.pyramids):
                assert _same(getattr(card.pyramids, f.name),
                             getattr(cpu.pyramids, f.name)), (kw, vb, f.name)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(problem):
    scene, pb, normal, ref, lod, _, _ = problem
    cfg = MvsConfig(**KW)
    H, _, pt = TF.warp_geometry(scene, cfg, pb.center, normal, ref, lod)
    with pytest.raises(ValueError, match="contiguous"):
        CF.warped_samples(scene.pyramids, H.transpose(-1, -2), pt, lod,
                          pb.cam_mask, 5)
    with pytest.raises(ValueError, match="int32"):
        CF.warped_samples(scene.pyramids, H, pt, lod.long(), pb.cam_mask, 5)
    # the view kernels keep one record per camera in shared memory: a block
    # beyond one block's share is refused
    Cv = CF.SMEM_PER_BLOCK // CF.view_smem_bytes(1, 0, 0) + 1
    Hv = torch.zeros((2, 3, Cv, 3, 3), device=H.device)
    with pytest.raises(ValueError, match="shared memory"):
        CF.view_deviation(scene.pyramids, Hv, pt[:2, None].expand(2, 3, 2),
                          lod[:2], torch.ones((2, Cv), dtype=torch.bool,
                                              device=H.device),
                          torch.ones((2, 3), dtype=torch.bool,
                                     device=H.device),
                          torch.zeros((2, 3, 121), device=H.device), 5)
    # the fitness kernel keeps at most a span of cameras and the window's
    # table in shared memory: any rig fits, and a window beyond one block's
    # share is refused, never truncated, with the largest radius named
    C = CF.SMEM_PER_BLOCK // CF.fitness_smem_bytes(1, 0) + 1
    assert C > CF.CAMERA_SPAN
    assert CF.fitness_smem_bytes(C, 105) <= CF.SMEM_PER_BLOCK
    assert CF.fitness_smem_bytes(C, 106) > CF.SMEM_PER_BLOCK
    Hb = torch.zeros((2, 3, C, 3, 3), device=H.device)
    big = MvsConfig(**{**KW, "patch_radius": 106})
    with pytest.raises(ValueError, match="shared memory.*r <= 105"):
        CF.score_windows(scene.pyramids, big, Hb, pt[:2, None].expand(2, 3, 2),
                         ref[:2], torch.ones((2, C), dtype=torch.bool,
                                             device=H.device), lod[:2],
                         torch.ones((2, 3), dtype=torch.bool, device=H.device))


@pytest.mark.gpu
@pytest.mark.parametrize("is_seed,rounds", [
    pytest.param(True, 2, id="seed-2"), pytest.param(False, 1,
                                                     id="expansion-1")])
def test_refine_graph_replays_the_eager_bits(problem, is_seed, rounds):
    """``RefineGraphs.refine`` against eager ``refine_batch`` at the same
    generator seeds: the key's first call (eager, then the capture) and
    two replays on new draws, every field and the iterations bit-equal,
    and each call counting the launches the eager refine counts."""
    scene, pb = problem[:2]
    cfg = MvsConfig(**KW)
    graphs = RefineGraphs()
    for seed in (0, 1, 2):
        CF.reset_launch_counts()
        want = tlc.refine_batch(scene, cfg, pb, 0.005, is_seed, rounds,
                                generator=torch.Generator(pb.device)
                                .manual_seed(seed))
        eager = dict(CF.LAUNCHES)
        CF.reset_launch_counts()
        got = graphs.refine(scene, cfg, pb, 0.005, is_seed, rounds,
                            generator=torch.Generator(pb.device)
                            .manual_seed(seed))
        assert dict(CF.LAUNCHES) == eager
        for f in dataclasses.fields(tpm.PatchBatch):
            assert torch.equal(getattr(got.batch, f.name),
                               getattr(want.batch, f.name)), (seed, f.name)
        assert torch.equal(got.iterations, want.iterations), seed
    assert graphs.counts == {"captured": 1, "replayed": 2, "eager": 0}


@pytest.mark.gpu
def test_refine_graph_replays_the_eager_bits_on_312_cameras(hemispheres):
    """The expansion refine on the 312-camera rig, rows past K1's camera
    tile: graphed against eager on the same draws, bit-equal."""
    scene, pb = hemispheres[312][:2]
    assert int(pb.cam_mask.sum(1).max()) > CF.CAMERA_TILE
    cfg = MvsConfig(**{**KW, "patch_radius": 15, "dist_weighting": 5.0})
    graphs = RefineGraphs()
    for seed in (0, 1):
        want = tlc.refine_batch(scene, cfg, pb, 0.05, False, 1,
                                generator=torch.Generator(pb.device)
                                .manual_seed(seed))
        got = graphs.refine(scene, cfg, pb, 0.05, False, 1,
                            generator=torch.Generator(pb.device)
                            .manual_seed(seed))
        for f in dataclasses.fields(tpm.PatchBatch):
            assert torch.equal(getattr(got.batch, f.name),
                               getattr(want.batch, f.name)), (seed, f.name)
    assert graphs.counts == {"captured": 1, "replayed": 1, "eager": 0}


@pytest.mark.gpu
def test_cli_reconstructs_a_312_camera_rig(cuda, tmp_path, monkeypatch):
    """``-r`` of a 312-view rig (the hemisphere at 320x240, r = 6, two
    expansion rounds) through the CLI on the card: K1 past its camera
    tile, the refine graphs, and a cloud at the end."""
    from benchmark import scenes
    from pais_mvs_tpu_torch import cli
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    from pais_mvs_tpu_torch.io import mvsbin
    cfg, sc, _ = hemisphere_rig(312, 320, 240, 60, cuda)
    cfg["config_txt"] = {"patchRadius": 6, "particleNum": 8,
                         "maxIteration": 10, "distWeighting": 2.0}
    scenes.write_files(sc, cfg, str(tmp_path))
    expand = Reconstructor.expand
    monkeypatch.setattr(Reconstructor, "expand",
                        lambda rec, max_rounds=10_000, autosave_path=None:
                        expand(rec, 2, autosave_path))
    monkeypatch.chdir(tmp_path)
    CF.reset_launch_counts()
    assert cli.main(["-r", "scene.nvm", "-o", "out", "--device",
                     "cuda"]) == 0
    cloud = mvsbin.read_mvs(str(tmp_path / "out" / "exp.mvs"))
    assert len(cloud.patches.centers) > len(sc.seed_points)
    assert CF.LAUNCHES["fitness"] > 0
    import json
    stats = json.load(open(tmp_path / "out" / "stats.json"))
    counters = stats["trace"]["counters"]
    assert counters["k1_tiled_rows"] > 0
    assert counters["scored_cams"] > 3 * counters["refined_rows"] // 2


@pytest.mark.gpu
def test_view_refine_graph_replays_the_eager_bits(problem, tmp_path):
    """The view path through an NCCL world of one (``refine_sharded`` at
    dp = vp = 1): graphed against eager on the same draws, bit-equal, with
    the psums captured in the graph."""
    import torch.distributed as dist

    from pais_mvs_tpu_torch.parallel.distributed import init_distributed
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    from pais_mvs_tpu_torch.parallel.sharded import refine_sharded
    scene, pb = problem[:2]
    cfg = MvsConfig(**KW)
    init_distributed(f"file://{tmp_path}/store", 0, 1, backend="nccl")
    try:
        mesh = make_mesh((1, 1))
        block = scene.view_block(0, 1)
        graphs = RefineGraphs()
        for seed in (0, 1, 2):
            args = (block, cfg, pb, 0.005, True, 1, mesh.patch, mesh.view)
            CF.reset_launch_counts()
            want = refine_sharded(*args, seed=seed)
            eager = dict(CF.LAUNCHES)
            CF.reset_launch_counts()
            got = refine_sharded(*args, seed=seed, refine=graphs.refine)
            assert dict(CF.LAUNCHES) == eager
            assert eager["view_moments"] > 0 and eager["fitness"] == 0
            for f in dataclasses.fields(tpm.PatchBatch):
                assert torch.equal(getattr(got.batch, f.name),
                                   getattr(want.batch, f.name)), (seed,
                                                                  f.name)
        assert graphs.counts == {"captured": 1, "replayed": 2, "eager": 0}
    finally:
        dist.destroy_process_group()
