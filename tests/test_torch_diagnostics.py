"""PyTorch port: the viewer's diagnostics (``pais_mvs_tpu_torch/
diagnostics.py``) against ``pais_mvs_tpu/diagnostics.py``, and the two
kernels' plain twins at B = 1 (the shape ``-v --reoptimize`` refines),
against the JAX package's jnp reference, on the shared tiny scene (the JAX
atlas carried across with ``convert.py``) and the same numpy inputs.

Bars: ``warped_windows`` the same NaN set and valid set, intensities
(0..255) to 1e-5 relative (the homographies differ in the last bits);
``sad_heatmap`` to twice the windows' bound in intensity, 2 * 1e-5 * 255
(a mean absolute deviation of values each that close); the writers byte-equal for the same inputs: the
PNG mosaics and the printed summary from the same windows (the heat map is
min-max scaled to uint8, so an ulp in a window can move a byte), the HTML
viewer (whose click readout names each package's own CLI module) and the
replay PLY; K1's twin the exact BIG set and 1e-4, K2's the same ok
set and 1e-5 (tests/test_torch_fitness.py's bars).
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu import diagnostics as JD
from pais_mvs_tpu.ops import fitness as JF
from pais_mvs_tpu_torch import diagnostics as TD
from pais_mvs_tpu_torch.ops import cuda_fitness as CF
from test_torch_fitness import _assert_fitness_match, _cfgs, problem  # noqa: F401

import jax.numpy as jnp

ROWS = (0, 7, 21)


def _sph(normal):
    n = np.asarray(normal, np.float64)
    return np.array([np.arccos(np.clip(n[2], -1, 1)),
                     np.arctan2(n[1], n[0])], np.float32)


def _patch(h, i, shift=0.0):
    return (h["center"][i] + np.float32(shift), _sph(h["normal"][i]),
            int(h["ref_cam"][i]), h["cam_mask"][i], int(h["lod"][i]))


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("shift,lod", [(0.0, None), (0.0, 1), (0.4, None)])
def test_warped_windows_match_jax(problem, row, shift, lod):  # noqa: F811
    jscene, tscene, h = problem
    jcfg, tcfg = _cfgs()
    c, sph, ref, mask, lv = _patch(h, row, shift)
    lv = lv if lod is None else lod
    jw, jv = JD.warped_windows(jscene, jcfg, c, sph, ref, mask, lv)
    tw, tv = TD.warped_windows(tscene, tcfg, c, sph, ref, mask, lv)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(np.isnan(tw), np.isnan(jw))
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5, equal_nan=True)
    m = tv & mask
    if m.any():
        np.testing.assert_allclose(TD.sad_heatmap(tw, m),
                                   JD.sad_heatmap(jw, m), rtol=0,
                                   atol=2 * 1e-5 * 255, equal_nan=True)


def test_some_windows_leave_the_frame(problem):  # noqa: F811
    """The off-surface case above really exercises the NaN set."""
    _, tscene, h = problem
    _, tcfg = _cfgs()
    nan = [np.isnan(TD.warped_windows(tscene, tcfg,
                                      *_patch(h, i, 0.4))[0]).any()
           for i in ROWS]
    assert any(nan)


def test_patch_mosaics_are_byte_equal(problem, tmp_path, capsys,  # noqa: F811
                                      monkeypatch):
    """Both writers on JAX's windows (the port's own are held above)."""
    jscene, tscene, h = problem
    jcfg, tcfg = _cfgs()
    monkeypatch.setattr(TD, "warped_windows",
                        lambda s, c, *a: JD.warped_windows(jscene, jcfg, *a))
    for i, shift in zip(ROWS, (0.0, 0.0, 0.4)):
        c, sph, ref, mask, lv = _patch(h, i, shift)
        JD.save_patch_diagnostics(jscene, jcfg, c, sph, ref, mask, lv,
                                  str(tmp_path / "jax"), i, fitness=0.25)
        want = capsys.readouterr().out
        path = TD.save_patch_diagnostics(tscene, tcfg, c, sph, ref, mask, lv,
                                         str(tmp_path / "port"), i,
                                         fitness=0.25)
        assert capsys.readouterr().out == want
        assert path == str(tmp_path / "port" / f"patch{i}_views.png")
        for name in (f"patch{i}_views.png", f"patch{i}_error.png"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("n,max_points", [(50, 200_000), (50, 16), (1, 10)])
def test_html_viewer_is_byte_equal(tmp_path, n, max_points):
    rng = np.random.default_rng(n)
    centers = rng.normal(size=(n, 3))
    colors = rng.uniform(0, 300, size=(n, 3))
    normals = rng.normal(size=(n, 3))
    cam_c = rng.normal(size=(3, 3))
    cam_ax = rng.normal(size=(3, 3))
    kw = dict(normals=normals, ids=np.arange(n) * 3, cam_centers=cam_c,
              cam_axes=cam_ax, cam_names=["a.jpg", "b.png", "c"],
              max_points=max_points)
    JD.write_html_viewer(str(tmp_path / "j.html"), centers, colors, **kw)
    TD.write_html_viewer(str(tmp_path / "t.html"), centers, colors, **kw)
    want = (tmp_path / "j.html").read_bytes()
    got = (tmp_path / "t.html").read_bytes()
    jax_cli, own_cli = b"python -m pais_mvs_tpu.cli -v", \
        b"python -m pais_mvs_tpu_torch.cli -v"
    assert want.count(jax_cli) == got.count(own_cli) == (n > 1)
    assert got == want.replace(jax_cli, own_cli)


def test_animate_ply_is_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    n = 40
    args = (rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
            rng.uniform(-10, 300, size=(n, 3)))
    JD.write_animate_ply(str(tmp_path / "j.ply"), *args)
    TD.write_animate_ply(str(tmp_path / "t.ply"), *args)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("row", ROWS)
def test_kernel_twins_at_batch_one(problem, row):  # noqa: F811
    """K1's and K2's plain twins (the CPU path of the dispatchers) on ONE
    patch, the batch ``-v --reoptimize`` refines: 16 particles, as a seed
    round draws them."""
    jscene, tscene, h = problem
    jcfg, tcfg = _cfgs()
    one = {k: v[row:row + 1] for k, v in h.items()}
    assert one["pos"].shape == (1, 16, 3)
    args = [one[k] for k in ("ref_cam", "cam_mask", "lod", "ray", "pos")]
    a = np.asarray(JF.patch_fitness(jscene, jcfg, *map(jnp.asarray, args)))
    b = CF.patch_fitness(tscene, tcfg, *map(torch.as_tensor, args)).numpy()
    _assert_fitness_match(a, b, min_valid=1)

    for shift in (0.0, 0.05):
        vargs = [one["center"] + np.float32(shift)] + [
            one[k] for k in ("normal", "ref_cam", "cam_mask", "lod")]
        jv, jc, jr, jok = (np.asarray(x) for x in JF.warped_patch_vectors(
            jscene, jcfg, *map(jnp.asarray, vargs)))
        tv, tc, tr, tok = (x.numpy() for x in CF.warped_patch_vectors(
            tscene, tcfg, *map(torch.as_tensor, vargs)))
        np.testing.assert_array_equal(tok, jok)
        if tok[0]:
            m = one["cam_mask"][0]
            np.testing.assert_allclose(tv[0][m], jv[0][m], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-5)
