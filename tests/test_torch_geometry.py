"""PyTorch port: ``ops/geometry.py`` against the JAX package's functions on
the same numpy inputs.

Tolerance: f32, rtol = atol = 1e-5. Both sides compute in float32 with the
same formulas; only the order of the 3-term sums inside einsum / pinv
differs, which moves results by a few ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pais_mvs_tpu.ops import geometry as jg
from pais_mvs_tpu_torch.ops import geometry as tg
import torch_parity  # noqa: F401  (one torch thread per worker)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def rig():
    """Five random cameras looking at the origin from ~2 units."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 4))
    R = np.asarray(jg.quat_to_rotation(_j(q)))
    C = rng.normal(size=(5, 3)) * 0.3 + np.array([0.0, 0.0, -2.0])
    T = -np.einsum("cij,cj->ci", R, C)
    f = np.stack([rng.uniform(400, 700, 5), rng.uniform(400, 700, 5)], -1)
    pp = np.stack([rng.uniform(150, 330, 5), rng.uniform(100, 250, 5)], -1)
    return R, T.astype(np.float32), C.astype(np.float32), f, pp


def test_spherical_and_quaternion():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(200, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    np.testing.assert_allclose(tg.normal_to_spherical(_t(n)).numpy(),
                               np.asarray(jg.normal_to_spherical(_j(n))),
                               **TOL)
    sph = rng.uniform(-3, 3, size=(200, 2))
    np.testing.assert_allclose(tg.spherical_to_normal(_t(sph)).numpy(),
                               np.asarray(jg.spherical_to_normal(_j(sph))),
                               **TOL)
    q = rng.normal(size=(50, 4))
    q[0] = 0.0                                  # identity fallback
    np.testing.assert_allclose(tg.quat_to_rotation(_t(q)).numpy(),
                               np.asarray(jg.quat_to_rotation(_j(q))), **TOL)


@pytest.mark.parametrize("distortion", [None, 0.05])
def test_project_per_camera(rig, distortion):
    R, T, C, f, pp = rig
    rng = np.random.default_rng(2)
    X = rng.normal(size=(64, 3)) * 0.3
    for c in range(5):
        jxy, jz = jg.project(_j(X), _j(R[c]), _j(T[c]), _j(f[c]), _j(pp[c]),
                             0.8 ** 2, distortion=distortion)
        txy, tz = tg.project(_t(X), _t(R[c]), _t(T[c]), _t(f[c]), _t(pp[c]),
                             0.8 ** 2, distortion=distortion)
        np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), **TOL)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    # one camera per row (the port's broadcast form) == per-row vmap
    cams = rng.integers(0, 5, size=64)
    txy, _ = tg.project(_t(X), _t(R[cams]), _t(T[cams]), _t(f[cams]),
                        _t(pp[cams]), _t(np.full(64, 0.8)))
    jxy = jax.vmap(lambda x, c: jg.project(x, _j(R)[c], _j(T)[c], _j(f)[c],
                                           _j(pp)[c], 0.8)[0])(
        _j(X), jnp.asarray(cams))
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), **TOL)


def test_pixel_rays_triangulation_normal(rig):
    R, T, C, f, pp = rig
    rng = np.random.default_rng(3)
    X = rng.normal(size=(32, 3)) * 0.2
    xy = np.stack([np.asarray(jg.project(_j(X), _j(R[c]), _j(T[c]), _j(f[c]),
                                         _j(pp[c]))[0]) for c in range(5)], 1)
    jd = jax.vmap(lambda p: jax.vmap(jg.pixel_to_world_dir)(
        p, _j(R), _j(C), _j(f), _j(pp)))(_j(xy))               # [B, C, 3]
    td = tg.pixel_to_world_dir(_t(xy), _t(R), _t(C), _t(f), _t(pp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)

    mask = rng.uniform(size=(32, 5)) < 0.8
    mask[:, :2] = True
    jX = jax.vmap(lambda d, m: jg.triangulate_rays(_j(C), d, m))(
        jd, jnp.asarray(mask))
    tX = tg.triangulate_rays(_t(C), td, torch.as_tensor(mask))
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-4,
                               atol=1e-5)   # pinv of a 3x3 normal matrix
    np.testing.assert_allclose(tX.numpy(), X, atol=1e-3)

    jn = jg.estimated_normal(_j(X), _j(C)[None], jnp.asarray(mask))
    tn = tg.estimated_normal(_t(X), _t(C)[None], torch.as_tensor(mask))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)

    o, d = rng.normal(size=(16, 3)), rng.normal(size=(16, 3))
    pp0, pn = rng.normal(size=(16, 3)), rng.normal(size=(16, 3))
    np.testing.assert_allclose(
        tg.ray_plane_intersect(_t(o), _t(d), _t(pp0), _t(pn)).numpy(),
        np.asarray(jg.ray_plane_intersect(_j(o), _j(d), _j(pp0), _j(pn))),
        rtol=1e-4, atol=1e-4)   # a ratio of two dot products: 1 ulp each


def test_plane_homography_apply_and_region_ratio(rig):
    R, T, C, f, pp = rig
    rng = np.random.default_rng(4)
    B = 48
    center = rng.normal(size=(B, 3)) * 0.2
    ref = rng.integers(0, 5, size=B)
    # patch planes face their reference camera, as refined patches do
    normal = C[ref] - center + rng.normal(size=(B, 3)) * 0.5
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    scale = 0.8 ** rng.integers(0, 3, size=B)
    args = lambda cv: (cv(center)[:, None], cv(normal)[:, None],
                       cv(R[ref])[:, None], cv(T[ref])[:, None],
                       cv(f[ref])[:, None], cv(pp[ref])[:, None],
                       cv(R), cv(T), cv(f), cv(pp), cv(scale)[:, None])
    jH, jok = jg.plane_homography(*args(_j))
    tH, tok = tg.plane_homography(*args(_t))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # 1e-5 of the pixel scale (s * f_ref ~ 500) on the two pixel rows, whose
    # small entries come out of cancellations between ~1e3-px terms; 1e-5
    # on the unitless third row
    jH, tH = np.asarray(jH), tH.numpy()
    px = (scale * f[ref, 0])[:, None, None, None]
    assert np.all(np.abs(tH - jH)[..., :2, :] <= 1e-5 * px)
    np.testing.assert_allclose(tH[..., 2, :], jH[..., 2, :], **TOL)
    # apply / region ratio on the same H: the same formulas, a few ulp
    pt = rng.uniform(0, 300, size=(B, 5, 2))
    juv, jw = jg.homography_apply(_j(jH), _j(pt))
    tuv, tw = tg.homography_apply(_t(jH), _t(pt))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-5,
                               atol=1e-3)   # |uv| reaches ~1e3 px
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(
        tg.homography_region_ratio(_t(jH), _t(pt)).numpy(),
        np.asarray(jg.homography_region_ratio(_j(jH), _j(pt))), **TOL)
