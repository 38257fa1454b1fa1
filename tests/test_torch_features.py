"""PyTorch port: feature seeding (``pais_mvs_tpu_torch/features/``) against
the JAX package's ``pais_mvs_tpu/features/`` on tests/test_features.py's
scenes, the same numpy inputs fed to both.

Bars, and why:
  * detect: octave, level, mask and sigma equal; score and the Gaussian
    stacks to 1e-5. The keypoints' sub-pixel positions agree to 2e-3 px,
    not bit for bit: the stacks differ by 1-2 ulp (XLA's convolution sums
    the taps in its own blocked order; the port sums them in tap order),
    and the quadratic offset divides two differences of them.
  * describe (on JAX's own keypoints): unit norm, and at least 99% of the
    masked descriptors to 1e-5. The orientation histogram bins each sample
    whole, so an ulp-level change of one sample's angle can move the peak:
    XLA's compiled ``describe_octave`` and its op-by-op evaluation disagree
    on some keypoints themselves. Every descriptor off the compiled one
    must equal the op-by-op one to 1e-5.
  * match_pair on identical descriptors: idx2 and good equal.
  * fundamental_from_rig: 1e-12 (the same float64 numpy).
  * merge_tracks: equal, on JAX's test case.
  * generate_seed_patches, on the 3-camera scene and the mixed-resolution
    rig: the same seed count and cam_masks, centres to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.features import describe as jdsc
from pais_mvs_tpu.features import detect as jdet
from pais_mvs_tpu.features import matching as jmat
from pais_mvs_tpu.features.seeding import generate_seed_patches as jseed
from pais_mvs_tpu.features.seeding import merge_tracks as jmerge
from pais_mvs_tpu.models.camera import _np_quat_to_rotation
from pais_mvs_tpu.ops import pyramid as pyr
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.features import describe as tdsc
from pais_mvs_tpu_torch.features import detect as tdet
from pais_mvs_tpu_torch.features import matching as tmat
from pais_mvs_tpu_torch.features.seeding import generate_seed_patches as tseed
from pais_mvs_tpu_torch.features.seeding import merge_tracks as tmerge
from pais_mvs_tpu_torch.models.camera import CameraParams

OCTAVES, K = 3, 128


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_cams=3, width=320, height=240, num_seeds=10,
                      seed=11)


@pytest.fixture(scope="module")
def detected(scene):
    """Both packages' keypoints and stacks on every camera."""
    out = []
    for img in scene.images:
        gray = pyr.rgb_to_gray(img).astype(np.float32)
        jk, jg = jdet.detect_keypoints(jnp.asarray(gray),
                                       num_octaves=OCTAVES, k_per_octave=K)
        tk, tg = tdet.detect_keypoints(torch.as_tensor(gray),
                                       num_octaves=OCTAVES, k_per_octave=K)
        out.append((jax.device_get(jk), [np.asarray(g) for g in jg], tk,
                    tg))
    return out


def _t(a):
    return torch.tensor(np.asarray(a))


def test_detect_matches_jax(detected):
    for cam, (jk, jg, tk, tg) in enumerate(detected):
        for name in ("octave", "level", "mask", "sigma", "sigma_oct"):
            np.testing.assert_array_equal(getattr(tk, name).numpy(),
                                          np.asarray(getattr(jk, name)),
                                          err_msg=f"cam {cam} {name}")
        np.testing.assert_allclose(tk.score.numpy(), jk.score, atol=1e-5,
                                   rtol=0)
        assert len(tg) == len(jg) == OCTAVES
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0)
        m = np.asarray(jk.mask)
        assert m.sum() > 30
        dxy = np.abs(tk.xy.numpy() - np.asarray(jk.xy))[m]
        assert dxy.max() < 2e-3, (cam, dxy.max())


def test_describe_matches_jax(detected):
    agree = total = 0
    for cam, (jk, jg, _, _) in enumerate(detected):
        for o, g in enumerate(jg):
            sel = slice(o * K, (o + 1) * K)
            args = (jk.xy_oct[sel], jk.sigma_oct[sel], jk.level[sel])
            want = np.asarray(jdsc.describe_octave(g, *args))
            got = tdsc.describe_octave(_t(g), *map(_t, args)).numpy()
            m = np.asarray(jk.mask)[sel]
            np.testing.assert_allclose(np.linalg.norm(got[m], axis=-1), 1.0,
                                       atol=1e-5)
            ok = np.abs(got - want).max(-1) <= 1e-5
            agree += int((ok & m).sum())
            total += int(m.sum())
            off = m & ~ok
            if off.any():
                # the whole octave (one shape per octave: op-by-op JAX
                # compiles each primitive once per shape)
                with jax.disable_jit():
                    eager = np.asarray(jdsc.describe_octave(
                        jnp.asarray(g), *map(jnp.asarray, args)))
                np.testing.assert_allclose(got[off], eager[off], atol=1e-5,
                                           rtol=0, err_msg=f"cam {cam} "
                                           f"octave {o}")
    assert agree >= 0.99 * total, (agree, total)


def test_match_pair_matches_jax(scene, detected):
    (jk0, jg0, _, _), (jk1, jg1, _, _) = detected[:2]
    descs = []
    for jk, jg in ((jk0, jg0), (jk1, jg1)):
        descs.append(np.concatenate([np.asarray(jdsc.describe_octave(
            g, jk.xy_oct[o * K:(o + 1) * K], jk.sigma_oct[o * K:(o + 1) * K],
            jk.level[o * K:(o + 1) * K])) for o, g in enumerate(jg)]))
    F = np.asarray(jmat.fundamental_from_rig(*_rig_pair(scene, 0, 1)),
                   np.float32)
    args = (descs[0], descs[1], np.asarray(jk0.xy), np.asarray(jk1.xy),
            np.asarray(jk0.mask), np.asarray(jk1.mask), F)
    want = jmat.match_pair(*map(jnp.asarray, args))
    got = tmat.match_pair(*map(_t, args))
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(want.idx2))
    np.testing.assert_array_equal(got.good.numpy(), np.asarray(want.good))
    assert got.good.sum() > 10


def _rig_pair(sc, i, j):
    """(R1, T1, K1, R2, T2, K2) of cameras i and j."""
    out = []
    for c in (i, j):
        p = sc.params[c]
        R = _np_quat_to_rotation(p.quaternion)
        h, w = sc.images[c].shape[:2]
        K_ = np.array([[p.focal[0], 0, w >> 1], [0, p.focal[1], h >> 1],
                       [0, 0, 1.0]])
        out += [R, -R @ p.center, K_]
    return tuple(out)


def test_fundamental_from_rig_matches_jax(scene):
    for i, j in ((0, 1), (2, 0), (1, 2)):
        np.testing.assert_allclose(
            tmat.fundamental_from_rig(*_rig_pair(scene, i, j)),
            jmat.fundamental_from_rig(*_rig_pair(scene, i, j)), atol=1e-12,
            rtol=0)


def test_merge_tracks_matches_jax():
    # tests/test_features.py::test_merge_tracks_consistency's case
    pairs = {
        (0, 1): (np.array([0, 1, 2]), np.array([0, 1, 2])),
        (1, 2): (np.array([0, 1]), np.array([0, 1])),
        (0, 2): (np.array([1, 3]), np.array([2, 3])),
    }
    got = tmerge(pairs, num_cams=3, k_per_cam=4, min_cam_num=3)
    assert got == jmerge(pairs, num_cams=3, k_per_cam=4, min_cam_num=3)
    assert got == [{0: 0, 1: 0, 2: 0}]


def _seed_case(case, scene):
    if case == "three_cameras":
        return scene.params, scene.images, 3, scene
    big = make_scene(num_cams=4, width=320, height=240, num_seeds=10,
                     seed=11)
    small = make_scene(num_cams=4, width=160, height=120, num_seeds=10,
                       seed=11, focal=0.5 * 1.1 * 320)
    return ([small.params[0]] + list(big.params[1:]),
            [small.images[0]] + list(big.images[1:]), 4, big)


@pytest.mark.parametrize("case", ["three_cameras", "mixed_resolution"])
def test_generate_seed_patches_matches_jax(case, scene):
    params, images, octaves, truth = _seed_case(case, scene)
    want = jseed(params, images, JCfg(min_cam_num=3), max_epipolar_dist=3.0,
                 k_per_octave=K, num_octaves=octaves)
    got = tseed([CameraParams(**dataclasses.asdict(p)) for p in params],
                images, TCfg(min_cam_num=3), max_epipolar_dist=3.0,
                k_per_octave=K, num_octaves=octaves, device="cpu")
    assert len(got[0]) == len(want[0]) > 5
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[3], want[3], atol=0)
    assert np.median(truth.surface_distance(got[0])) < 0.01
