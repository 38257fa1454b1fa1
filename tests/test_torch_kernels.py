"""PyTorch port: the CUDA kernels against their plain PyTorch twins, on the
card. Marked ``gpu``; without a CUDA device every test skips.

This file imports neither JAX nor ``pais_mvs_tpu`` and uses no conftest
fixture, so it also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Tolerances: K1's BIG set exactly, values to 1e-4 (relative above 1): the
per-pixel terms round alike (the kernels build with --fmad=false) and only
the window sum's order differs; K2's ok set exactly, samples to 1e-5.
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

BIG = 1e20
KW = dict(patch_radius=5, max_lod=4, particle_num=8, max_iteration=12,
          batch_size=64, dist_weighting=5.0 / 3.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    CF.build_kernels()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem(cuda):
    """Seeds of a small synthetic scene with bench.py's wide hypothesis
    noise (16 particles per seed)."""
    sc = make_scene(num_cams=5, width=200, height=150, num_seeds=40)
    cfg = MvsConfig(**KW)
    scene = build_scene(sc.params, sc.images, cfg, device=cuda)
    pb = tlc.prepare_seeds(scene, cfg, tpm.from_seeds(
        sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
        device=cuda))
    normal = pb.normal()
    ref = tlc.set_reference_camera(scene, normal, pb.cam_mask)
    depth, ray = tlc.set_depth_and_ray(scene, pb.center, ref)
    lod = tlc.set_lod(scene, cfg, pb.center, ref)
    rng = np.random.default_rng(7)
    noise = torch.tensor(rng.normal(size=(pb.capacity, 16, 3))
                         * np.array([0.3, 0.3, 0.002]), dtype=torch.float32,
                         device=cuda)
    pos = torch.stack([pb.normal_sph[:, 0], pb.normal_sph[:, 1], depth],
                      -1)[:, None, :] + noise
    return scene, pb, normal, ref, lod, ray, pos


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [3, 6, 15, 24])
def test_fitness_kernel_matches_plain(problem, radius):
    scene, pb, _, ref, lod, ray, pos = problem
    cfg = MvsConfig(**{**KW, "patch_radius": radius,
                       "dist_weighting": radius / 3.0})
    H, pt, pvalid = TF.fitness_geometry(scene, cfg, ref, pb.cam_mask, lod,
                                        ray, pos)
    args = (scene.pyramids, cfg, H, pt, ref, pb.cam_mask, lod, pvalid)
    before = CF.LAUNCHES["fitness"]
    a = TF.score_windows(*args).cpu().numpy()
    b = CF.score_windows(*args).cpu().numpy()
    assert CF.LAUNCHES["fitness"] == before + 1
    np.testing.assert_array_equal(a >= BIG, b >= BIG)
    ok = a < BIG
    assert ok.any()
    np.testing.assert_allclose(b[ok], a[ok], rtol=1e-4, atol=1e-4)
    # inactive swarms come back BIG, active ones unchanged
    act = torch.arange(pos.shape[0], device=pos.device) % 2 == 0
    c = CF.score_windows(*args, act).cpu().numpy()
    am = act.cpu().numpy()
    np.testing.assert_array_equal(c[am], b[am])
    assert np.all(c[~am] >= BIG)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [5, 15])
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
    # the fitness kernel keeps one register array of MAX_CAMERAS samples per
    # pixel: a larger rig is refused, never truncated
    Hb = torch.zeros((2, 3, CF.MAX_CAMERAS + 1, 3, 3), device=H.device)
    with pytest.raises(ValueError, match=f"at most {CF.MAX_CAMERAS} cameras"):
        CF.score_windows(scene.pyramids, cfg, Hb, pt[:2, None].expand(2, 3, 2),
                         ref[:2], pb.cam_mask[:2], lod[:2],
                         torch.ones((2, 3), dtype=torch.bool, device=H.device))
