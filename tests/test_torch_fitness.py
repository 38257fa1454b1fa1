"""PyTorch port: the photoconsistency fitness and the NCC window vectors
against the JAX package's jnp reference (``pais_mvs_tpu/ops/fitness.py``,
the path ``fitness_backend="auto"`` takes on the CPU), on the same atlas
(carried across with ``convert.py``) and the same numpy-made hypotheses.

Tolerances:
  * fitness: the BIG (rejected) set must match EXACTLY, values to
    rtol = atol = 1e-4 — both sides compute the same f32 per-pixel terms;
    the window sums run in another order (~1e-6 relative);
  * NCC: the ok/drop set exactly; unit vectors, the [C, C] table and the
    mean correlation to 1e-5 (one L2 norm and a 961-term dot product in
    f32, summed in another order).

The CUDA kernels are held to their plain twins on the card by
tests/test_torch_kernels.py (marked ``gpu``) and by ``chip_smoke.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.ops import fitness as JF
from pais_mvs_tpu.ops import geometry as jgeom
from pais_mvs_tpu.ops import lifecycle as jlc
from pais_mvs_tpu.models import patch as jpm
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.convert import scene_from_numpy
from pais_mvs_tpu_torch.ops import cuda_fitness as CF
from pais_mvs_tpu_torch.ops import fitness as TF
import torch_parity  # noqa: F401  (one torch thread per worker)

BIG = 1e20


def _cfgs(**kw):
    base = dict(patch_radius=5, max_lod=4, particle_num=8, max_iteration=12,
                batch_size=64, dist_weighting=5.0 / 3.0)
    base.update(kw)
    return JCfg(**base), TCfg(**base)


@pytest.fixture(scope="module")
def problem(tiny_scene, tiny_built, tiny_cfg):
    """bench.py's selftest hypotheses (bench.py:135-145) on the tiny scene:
    every seed, 16 particles around its prepared state with the bench's
    deliberately wide noise (0.3 rad, 0.3 rad, 0.002 depth)."""
    scene = tiny_built
    pb = jpm.from_seeds(tiny_scene.seed_centers, tiny_scene.seed_cam_masks,
                        tiny_scene.seed_img_points)
    pb = jlc.prepare_seeds(scene, tiny_cfg, pb)
    normal = jgeom.spherical_to_normal(jnp.asarray(pb.normal_sph))
    ref_cam = jlc.set_reference_camera(scene, normal, pb.cam_mask)
    depth, ray = jlc.set_depth_and_ray(scene, pb.center, ref_cam)
    lod = jlc.set_lod(scene, tiny_cfg, pb.center, ref_cam)
    B, P = pb.center.shape[0], 16
    rng = np.random.default_rng(7)
    noise = rng.normal(size=(B, P, 3)) * np.array([0.3, 0.3, 0.002])
    pos = (np.stack([np.asarray(pb.normal_sph[:, 0]),
                     np.asarray(pb.normal_sph[:, 1]),
                     np.asarray(depth)], -1)[:, None, :]
           + noise).astype(np.float32)
    host = dict(ref_cam=np.array(ref_cam), cam_mask=np.array(pb.cam_mask),
                lod=np.array(lod), ray=np.array(ray), pos=pos,
                center=np.array(pb.center), normal=np.array(normal))
    tscene = scene_from_numpy(dataclasses.asdict(jax.device_get(scene)),
                              device="cpu")
    return scene, tscene, host


def _run_both(problem, jcfg, tcfg, active=None):
    jscene, tscene, h = problem
    a = np.asarray(JF.patch_fitness(
        jscene, jcfg, jnp.asarray(h["ref_cam"]), jnp.asarray(h["cam_mask"]),
        jnp.asarray(h["lod"]), jnp.asarray(h["ray"]), jnp.asarray(h["pos"])))
    t = {k: torch.as_tensor(v) for k, v in h.items()}
    b = TF.patch_fitness(tscene, tcfg, t["ref_cam"], t["cam_mask"], t["lod"],
                         t["ray"], t["pos"], active=active).numpy()
    return a, b


def _assert_fitness_match(a, b, min_valid):
    np.testing.assert_array_equal(a >= BIG, b >= BIG)
    ok = a < BIG
    assert ok.sum() >= min_valid, ok.sum()
    np.testing.assert_allclose(b[ok], a[ok], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("radius", [3, 6, 15])
def test_patch_fitness_matches_jnp_wide_noise(problem, radius):
    jcfg, tcfg = _cfgs(patch_radius=radius, dist_weighting=radius / 3.0)
    a, b = _run_both(problem, jcfg, tcfg)
    _assert_fitness_match(a, b, min_valid=40)


@pytest.mark.parametrize("dist,diff,grad", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True), (True, True, False), (True, False, True),
    (False, True, True), (True, True, True)])
def test_patch_fitness_adaptive_flags(problem, dist, diff, grad):
    """All 8 on/off combinations of the adaptive weights (as
    tests/test_pallas_fitness.py sweeps them for the Pallas kernel)."""
    jcfg, tcfg = _cfgs(adaptive_distance_enable=dist,
                       adaptive_difference_enable=diff,
                       adaptive_gradient_enable=grad)
    a, b = _run_both(problem, jcfg, tcfg)
    _assert_fitness_match(a, b, min_valid=40)


@pytest.fixture(scope="module")
def problem12():
    """A 12-camera synthetic rig (more cameras than the fitness kernel's
    first form could take), r=3: a few seeds, 4 particles each with the
    bench's wide noise."""
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.models.camera import build_scene
    jcfg, tcfg = _cfgs(patch_radius=3, dist_weighting=1.0)
    sc = make_scene(num_cams=12, width=120, height=90, num_seeds=8, seed=4)
    scene = build_scene(sc.params, sc.images, jcfg)
    pb = jlc.prepare_seeds(scene, jcfg, jpm.from_seeds(
        sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points))
    normal = jgeom.spherical_to_normal(jnp.asarray(pb.normal_sph))
    ref_cam = jlc.set_reference_camera(scene, normal, pb.cam_mask)
    depth, ray = jlc.set_depth_and_ray(scene, pb.center, ref_cam)
    lod = jlc.set_lod(scene, jcfg, pb.center, ref_cam)
    tscene = scene_from_numpy(dataclasses.asdict(jax.device_get(scene)),
                              device="cpu")
    base = np.stack([np.asarray(pb.normal_sph[:, 0]),
                     np.asarray(pb.normal_sph[:, 1]), np.asarray(depth)],
                    -1)[:, None, :]
    host = dict(ref_cam=np.array(ref_cam), cam_mask=np.array(pb.cam_mask),
                lod=np.array(lod), ray=np.array(ray), base=base)
    return scene, tscene, host, jcfg, tcfg


@pytest.mark.parametrize("noise_seed", [0, 1])
def test_patch_fitness_matches_jnp_twelve_cameras(problem12, noise_seed):
    """The plain twin (the fitness kernel's contract beyond 8 cameras)
    against JAX's jnp ``patch_fitness`` on a 12-camera rig."""
    jscene, tscene, h, jcfg, tcfg = problem12
    assert h["cam_mask"].shape[1] == 12 and h["cam_mask"].sum(1).max() > 8
    noise = np.random.default_rng(noise_seed).normal(
        size=(h["base"].shape[0], 4, 3)) * np.array([0.3, 0.3, 0.002])
    pos = (h["base"] + noise).astype(np.float32)
    args = [h["ref_cam"], h["cam_mask"], h["lod"], h["ray"], pos]
    a = np.asarray(JF.patch_fitness(jscene, jcfg, *map(jnp.asarray, args)))
    b = TF.patch_fitness(tscene, tcfg, *map(torch.as_tensor, args)).numpy()
    _assert_fitness_match(a, b, min_valid=4)


def test_dispatcher_runs_plain_twin_on_cpu(problem):
    """CPU tensors go to the plain twins, the geometry's and K1's: same
    values, no kernel launch."""
    _, tscene, h = problem
    _, tcfg = _cfgs()
    t = {k: torch.as_tensor(v) for k, v in h.items()}
    args = (tscene, tcfg, t["ref_cam"], t["cam_mask"], t["lod"], t["ray"],
            t["pos"])
    before = dict(CF.LAUNCHES)
    act = torch.arange(t["pos"].shape[0]) % 2 == 0
    a = TF.patch_fitness(*args, active=act)
    b = CF.patch_fitness(*args, active=act)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = TF.fitness_geometry(*args)
    got = CF.fitness_geometry(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert want[2].any()
    assert CF.LAUNCHES == before


def test_plain_twin_scores_only_active_rows(problem):
    """The plain twin gives an inactive swarm BIG, as the kernel does, and
    an active one the bits it has when every swarm is scored."""
    _, tscene, h = problem
    _, tcfg = _cfgs()
    t = {k: torch.as_tensor(v) for k, v in h.items()}
    args = (tscene, tcfg, t["ref_cam"], t["cam_mask"], t["lod"], t["ray"],
            t["pos"])
    act = torch.arange(t["pos"].shape[0]) % 3 == 0
    every = TF.patch_fitness(*args).numpy()
    some = TF.patch_fitness(*args, active=act).numpy()
    none = TF.patch_fitness(*args, active=torch.zeros_like(act)).numpy()
    np.testing.assert_array_equal(some[act.numpy()], every[act.numpy()])
    assert (some[~act.numpy()] >= BIG).all() and (none >= BIG).all()
    assert (every < BIG).any()


def _ncc_both(problem, jcfg, tcfg, center):
    jscene, tscene, h = problem
    ja = JF.warped_patch_vectors(
        jscene, jcfg, jnp.asarray(center), jnp.asarray(h["normal"]),
        jnp.asarray(h["ref_cam"]), jnp.asarray(h["cam_mask"]),
        jnp.asarray(h["lod"]))
    tb = CF.warped_patch_vectors(
        tscene, tcfg, torch.as_tensor(center), torch.as_tensor(h["normal"]),
        torch.as_tensor(h["ref_cam"]), torch.as_tensor(h["cam_mask"]),
        torch.as_tensor(h["lod"]))
    return [np.asarray(x) for x in ja], [x.numpy() for x in tb]


@pytest.mark.parametrize("radius,shift", [(5, 0.0), (6, 0.0), (15, 0.0),
                                          (5, 0.05)])
def test_warped_patch_vectors_match_jnp(problem, radius, shift):
    """Same ok set; unit vectors (visible cameras of ok patches), the NCC
    table and the mean correlation to 1e-5. ``shift`` moves the centres off
    the surface so some windows leave the frame and correlations drop."""
    jcfg, tcfg = _cfgs(patch_radius=radius, dist_weighting=radius / 3.0)
    center = problem[2]["center"] + np.float32(shift)
    (jv, jc, jr, jok), (tv, tc, tr, tok) = _ncc_both(problem, jcfg, tcfg,
                                                     center)
    np.testing.assert_array_equal(jok, tok)
    assert tok.sum() >= 10
    m = problem[2]["cam_mask"][tok]
    np.testing.assert_allclose(tv[tok][m], jv[tok][m], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc[tok], jc[tok], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-5)
