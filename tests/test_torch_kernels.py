"""PyTorch port: the CUDA kernels against their plain PyTorch twins, on the
card. Marked ``gpu``; without a CUDA device every test skips.

This file imports neither JAX nor ``pais_mvs_tpu`` and uses no conftest
fixture, so it also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Tolerances: K1's BIG set exactly, values to 1e-4 (relative above 1): the
per-pixel terms round alike (the kernels build with --fmad=false) and only
the window sum's order differs; K1 is checked at every particle-tile
remainder (P in {1, 7, 16, 30}) and on a 12-camera rig; K2's ok set exactly, samples to 1e-5, in
both its modes (NCC and view); its reference-window entry equal (the same
pixels read); M to 1e-4 relative (the kernels sum the particles in the
plain version's order).
"""

import numpy as np
import pytest
import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.data.synthetic import make_scene
from pais_mvs_tpu_torch.models import patch as tpm
from pais_mvs_tpu_torch.models.camera import build_scene
from pais_mvs_tpu_torch.ops import cuda_fitness as CF
from pais_mvs_tpu_torch.ops import fitness as TF
from pais_mvs_tpu_torch.ops import lifecycle as tlc
from pais_mvs_tpu_torch.tools import microbench_kernel as MB

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


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [3, 15, 24])
def test_sampler_view_kernel_matches_plain(problem, radius):
    """K2 in its view mode: every particle, margins (2, 3), act and pvalid
    masks switching rows off."""
    scene, pb, _, ref, lod, ray, pos = problem
    cfg = MvsConfig(**{**KW, "patch_radius": radius})
    H, pt, pvalid = TF.fitness_geometry(scene, cfg, ref, pb.cam_mask, lod,
                                        ray, pos)
    act = pb.cam_mask.clone()
    act[::4, 2] = False
    args = (scene.pyramids, H, pt, lod, act, pvalid, radius)
    before = CF.LAUNCHES["sampler_view"]
    a = TF.warped_samples_view(*args).cpu().numpy()
    b = CF.warped_samples_view(*args).cpu().numpy()
    assert CF.LAUNCHES["sampler_view"] == before + 1
    assert b.shape == (pos.shape[0], scene.num_cameras, pos.shape[1],
                       (2 * radius + 1) ** 2)
    np.testing.assert_array_equal(a > -5e8, b > -5e8)
    assert (a > -5e8).mean() > 0.2
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [3, 15])
@pytest.mark.parametrize("edges", [False, True])
def test_ref_window_kernel_matches_plain(problem, radius, edges):
    """The sampler's reference-window entry: nearest lookups of the
    reference camera, 0 in the rows this rank does not own; equal."""
    scene, pb, _, ref, lod, ray, pos = problem
    cfg = MvsConfig(**{**KW, "patch_radius": radius})
    _, pt, _ = TF.fitness_geometry(scene, cfg, ref, pb.cam_mask, lod, ray,
                                   pos)
    own = torch.arange(pt.shape[0], device=pt.device) % 3 != 0
    args = (scene.pyramids, pt, ref, own, lod, radius, edges)
    before = CF.LAUNCHES["ref_window"]
    a = TF.reference_windows(*args).cpu().numpy()
    b = CF.reference_windows(*args).cpu().numpy()
    assert CF.LAUNCHES["ref_window"] == before + 1
    assert b.shape == (1 + edges, *pt.shape[:2], (2 * radius + 1) ** 2)
    np.testing.assert_array_equal(b, a)
    assert (a[0] != 0).mean() > 0.2


@pytest.mark.gpu
@pytest.mark.parametrize("variant", MB.VARIANTS)
def test_microbench_kernels_match_plain(cuda, variant):
    box = MB.make_box(0, cuda)
    before = CF.LAUNCHES[f"microbench_{variant}"]
    got = MB.run_grid(box, variant=variant)
    assert CF.LAUNCHES[f"microbench_{variant}"] == before + 1
    assert MB.max_rel_err(got, MB.run_grid_plain(box)) <= 1e-4


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
    # the fitness kernel keeps each camera's samples and records in shared
    # memory: a rig beyond one block's share is refused, never truncated
    C = CF.SMEM_PER_BLOCK // CF.fitness_smem_bytes(1, 0) + 1
    assert CF.fitness_smem_bytes(C, 5) > CF.SMEM_PER_BLOCK
    Hb = torch.zeros((2, 3, C, 3, 3), device=H.device)
    with pytest.raises(ValueError, match="shared memory"):
        CF.score_windows(scene.pyramids, cfg, Hb, pt[:2, None].expand(2, 3, 2),
                         ref[:2], pb.cam_mask[:2], lod[:2],
                         torch.ones((2, 3), dtype=torch.bool, device=H.device))
