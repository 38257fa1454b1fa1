"""PyTorch port: the patch lifecycle and the whole refinement slice
(``refine_batch`` in seed and in expansion mode) against the JAX package on
the CPU, on the same atlas (``convert.py``) and the same seed batch.

Tolerances:
  * the per-step primitives are f32 formulas on identical inputs:
    integers/masks exact, floats 1e-5 (prepare_seeds goes through a 3x3
    pinv: 1e-4);
  * ``refine_batch`` with the JAX run's PSO draws injected: ``valid``
    agreement >= 0.95, median centre difference <= 1e-4 over patches both
    keep, accepted counts within +-2. Not exact because XLA fuses
    multiply-adds into FMAs on the CPU and torch does not, and the PSO's
    argmin chains amplify those 1-ulp differences (tests/test_torch_pso.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.models import patch as jpm
from pais_mvs_tpu.ops import geometry as jgeom
from pais_mvs_tpu.ops import lifecycle as jlc
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.convert import patch_batch_from_numpy, scene_from_numpy
from pais_mvs_tpu_torch.models import patch as tpm
from pais_mvs_tpu_torch.ops import lifecycle as tlc
from torch_parity import refine_draws

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(patch_radius=5, max_lod=4, particle_num=8, max_iteration=12,
          batch_size=64, dist_weighting=5.0 / 3.0)


@pytest.fixture(scope="module")
def both(tiny_scene, tiny_built):
    jcfg, tcfg = JCfg(**KW), TCfg(**KW)
    jpb = jpm.from_seeds(tiny_scene.seed_centers, tiny_scene.seed_cam_masks,
                         tiny_scene.seed_img_points)
    jpb = jax.device_get(jlc.prepare_seeds(tiny_built, jcfg, jpb))
    tscene = scene_from_numpy(dataclasses.asdict(jax.device_get(tiny_built)),
                              device="cpu")
    tpb = patch_batch_from_numpy(dataclasses.asdict(jpb), device="cpu")
    return tiny_built, jcfg, jpb, tscene, tcfg, tpb


def test_prepare_seeds_matches(tiny_scene, both):
    _, _, jpb, tscene, tcfg, _ = both
    tpb = tlc.prepare_seeds(tscene, tcfg, tpm.from_seeds(
        tiny_scene.seed_centers, tiny_scene.seed_cam_masks,
        tiny_scene.seed_img_points, device="cpu"))
    np.testing.assert_allclose(tpb.center.numpy(), jpb.center, rtol=1e-4,
                               atol=1e-4)   # through a 3x3 pinv
    np.testing.assert_allclose(tpb.normal_sph.numpy(), jpb.normal_sph,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tpb.valid.numpy(), jpb.valid)


def test_step_primitives_match(both):
    jscene, jcfg, jpb, tscene, tcfg, tpb = both
    jn = jgeom.spherical_to_normal(jnp.asarray(jpb.normal_sph))
    tn = tpb.normal()
    jref = jlc.set_reference_camera(jscene, jn, jpb.cam_mask)
    tref = tlc.set_reference_camera(tscene, tn, tpb.cam_mask)
    np.testing.assert_array_equal(tref.numpy(), np.asarray(jref))
    assert tref.dtype == torch.int32

    jd, jray = jlc.set_depth_and_ray(jscene, jpb.center, jref)
    td, tray = tlc.set_depth_and_ray(tscene, tpb.center, tref)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(tray.numpy(), np.asarray(jray), **TOL)

    jdr, jdrop = jlc.set_depth_range(jscene, jcfg, jpb.center, jray, jd, jref,
                                     jpb.cam_mask, jnp.float32(0.005))
    tdr, tdrop = tlc.set_depth_range(tscene, tcfg, tpb.center, tray, td, tref,
                                     tpb.cam_mask, torch.tensor(0.005))
    np.testing.assert_allclose(tdr.numpy(), np.asarray(jdr), **TOL)
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))

    jlod = jlc.set_lod(jscene, jcfg, jpb.center, jref)
    tlod = tlc.set_lod(tscene, tcfg, tpb.center, tref)
    np.testing.assert_array_equal(tlod.numpy(), np.asarray(jlod))

    # visibility pruning off the surface too, so cameras get removed
    for shift in (0.0, 0.03):
        c = np.asarray(jpb.center) + np.float32(shift)
        jm, jc, jdr2 = jlc.remove_invisible_cameras(
            jscene, jcfg, jnp.asarray(c), jn, jref, jpb.cam_mask, jlod)
        tm, tc, tdr2 = tlc.remove_invisible_cameras(
            tscene, tcfg, torch.tensor(c), tn, tref, tpb.cam_mask, tlod)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tdr2.numpy(), np.asarray(jdr2))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)

    jprio = jlc.set_priority(jscene, jnp.asarray(jpb.fitness) + 1.0,
                             jc, jm, jlod)
    tprio = tlc.set_priority(tscene, tpb.fitness + 1.0, tc, tm, tlod)
    np.testing.assert_allclose(tprio.numpy(), np.asarray(jprio), **TOL)

    jip, jcol = jlc.set_image_points_and_color(jscene, jpb.center, jref)
    tip, tcol = tlc.set_image_points_and_color(tscene, tpb.center, tref)
    np.testing.assert_allclose(tip.numpy(), np.asarray(jip), rtol=1e-5,
                               atol=1e-3)   # pixels, |xy| ~ 1e2
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))


def test_runtime_filter_and_rehydrate_match(both):
    jscene, jcfg, jpb, tscene, tcfg, tpb = both
    rng = np.random.default_rng(3)
    B = jpb.center.shape[0]
    fit = rng.uniform(0.0, 12.0, B).astype(np.float32)
    corr = rng.uniform(0.5, 1.0, B).astype(np.float32)
    jb = jlc.rehydrate_batch(jscene, jcfg, jpb.replace(
        fitness=jnp.asarray(fit), correlation=jnp.asarray(corr)),
        jnp.float32(0.005))
    tb = tlc.rehydrate_batch(tscene, tcfg, tpb.replace(
        fitness=torch.tensor(fit), correlation=torch.tensor(corr)), 0.005)
    for name in ("ref_cam", "lod", "valid"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    for name in ("depth", "depth_range", "priority"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(getattr(jb, name)), **TOL)
    jk = jlc.apply_runtime_filter(jscene, jcfg, jb).valid
    tk = tlc.apply_runtime_filter(tscene, tcfg, tb).valid
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < int(tk.sum()) < B


@pytest.mark.parametrize("is_seed,rounds", [
    pytest.param(True, 2, id="2"),
    pytest.param(False, 1, id="expansion-1")])
def test_refine_batch_slice_matches_jax(tiny_scene, both, is_seed, rounds):
    """The whole refinement slice at tiny size, injected draws: seed mode
    (full normal range, doubled swarms) and the expansion mode that
    ``Reconstructor.expand`` runs (normal bounds narrowed to
    +-pi/reduceNormalRange around the parent's, one round, P and T not
    doubled). The parents' normals are set (prepare_seeds)."""
    jscene, jcfg, jpb, tscene, tcfg, tpb = both
    key = jax.random.PRNGKey(0)
    B = jpb.center.shape[0]
    k = 2 if is_seed else 1
    P, T = k * KW["particle_num"], k * KW["max_iteration"]
    jres = jlc.refine_batch(jscene, jcfg, jax.tree.map(jnp.asarray, jpb),
                            key, jnp.float32(0.005), is_seed, rounds)
    tres = tlc.refine_batch(tscene, tcfg, tpb, 0.005, is_seed, rounds,
                            draws=refine_draws(key, rounds, B, P, T))
    jv = np.asarray(jres.batch.valid)
    tv = tres.batch.valid.numpy()
    assert (jv == tv).mean() >= 0.95, (jv.sum(), tv.sum())
    assert abs(int(jv.sum()) - int(tv.sum())) <= 2
    both_v = jv & tv
    assert both_v.sum() >= 0.5 * B
    dc = np.linalg.norm(tres.batch.center.numpy()[both_v]
                        - np.asarray(jres.batch.center)[both_v], axis=-1)
    assert np.median(dc) <= 1e-4, np.median(dc)
    # and the slice does its job: accepted seeds sit on the plane
    d = tiny_scene.surface_distance(tres.batch.center.numpy()[tv])
    assert np.median(d) < 0.003
