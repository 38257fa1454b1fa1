"""PyTorch port: the scene build's pixel steps (``ops/pyramid.py``) on the
CPU, through their plain twins, against the JAX package's numpy build
(``pais_mvs_tpu/ops/pyramid.py``), and ``build_scene`` at odd image sizes.

Tolerance: none. Every twin is held BIT FOR BIT to its numpy function
(float64 throughout, the same order of operations, running sums in index
order), and the packed bf16 atlases to JAX's ``build_scene``. Inputs are
seeded numpy uint8 images at odd shapes, lodRatio 0.8 and 0.5, window
radius 3 and 15 (at 15 the deep levels are smaller than the window)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.models.camera import build_scene as j_build
from pais_mvs_tpu.ops import pyramid as jp
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.models.camera import build_scene as t_build
from pais_mvs_tpu_torch.ops import pyramid as tp
import torch_parity  # noqa: F401  (one torch thread per worker)

SHAPES = [(97, 131), (240, 180), (61, 1)]


def _image(shape, seed):
    """A seeded uint8 RGB image: smooth structure plus noise, so that the
    pyramid levels, edges and variances are all non-trivial."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(x / 7.0 + seed) * np.cos(y / 11.0)
    img = base[..., None] + rng.normal(0, 25, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _eq(a: np.ndarray, b: torch.Tensor, what: str):
    b = b.numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _levels(shape, ratio, cap=8):
    h, w = shape
    return tp.level_dims(h, w, ratio, tp.max_lod_for(w, h, ratio, cap))


@pytest.mark.parametrize("shape", SHAPES)
def test_gray_and_level_dims(shape):
    img = _image(shape, 1)
    _eq(jp.rgb_to_gray(img), tp.rgb_to_gray(torch.from_numpy(img)), "gray")
    g2 = img[..., 0]
    _eq(jp.rgb_to_gray(g2), tp.rgb_to_gray(torch.from_numpy(g2)), "gray 2-D")
    for ratio in (0.8, 0.5):
        h, w = shape
        ml = jp.max_lod_for(w, h, ratio, 8)
        _, _, dims = jp.build_pyramid(jp.rgb_to_gray(img), ratio, ml)
        np.testing.assert_array_equal(dims, tp.level_dims(h, w, ratio, ml))


@pytest.mark.parametrize("ratio", [0.8, 0.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_area_resize_and_antiderivative(shape, ratio):
    gray = jp.rgb_to_gray(_image(shape, 2))
    f, F = jp._antiderivative_axis0(gray)
    tg = torch.from_numpy(gray)
    tF = tp.antiderivative(tg.double())
    _eq(F, tF, "antiderivative")
    for h, w in _levels(shape, ratio)[1:]:
        want = jp.area_resize(gray, int(h), int(w), (f, F))
        _eq(want, tp.area_resize(tg, int(h), int(w), tF), f"area {h}x{w}")
        _eq(want, tp.area_resize(tg, int(h), int(w)), f"area {h}x{w}, own F")
        # the two passes the card runs, with the level's quantization
        tmp = tp.resample_rows(tg.double(), tF, int(h))
        lvl = tp.resample_cols(tmp, tp.row_antiderivative(tmp), int(w))
        _eq(np.clip(np.round(want), 0, 255), lvl, f"level {h}x{w}")


@pytest.mark.parametrize("ratio", [0.8, 0.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_sobel_and_variance(shape, ratio):
    gray = jp.rgb_to_gray(_image(shape, 3))
    levels, edges, _ = jp.build_pyramid(gray, ratio,
                                        len(_levels(shape, ratio)) - 1)
    flat = np.full((5, 7), 9.0)              # hi == lo: an all-zero plane
    for g, e in list(zip(levels, edges)) + [(flat, np.zeros((5, 7)))]:
        tg = torch.from_numpy(g.astype(np.float64))
        _eq(jp.sobel_magnitude(g), tp.sobel_magnitude(tg),
            f"sobel {g.shape}")
        np.testing.assert_array_equal(
            e, tp.sobel_magnitude(tg).float().numpy())
        # the magnitude's range, as sobel_magnitude computes it
        p = np.pad(g.astype(np.float64), 1, mode="reflect")
        gx, gy = p[1:-1, 2:] - p[1:-1, :-2], p[2:, 1:-1] - p[:-2, 1:-1]
        mag = np.sqrt(gx * gx + gy * gy)
        _eq(np.array([mag.min(), mag.max()]), tp.edge_range(tg), "range")
        for radius in (3, 15):
            _eq(jp.window_variance_map(g, radius),
                tp.window_variance_map(torch.from_numpy(g), radius),
                f"variance {g.shape} r={radius}")
    assert min(levels[-1].shape) < 2 * 15 + 1    # a level under the window


def _bits(a):
    """A numpy array of a JAX or torch field, bf16 as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _scene_bits(s):
    return {f.name: _bits(getattr(part, f.name))
            for part in (s.rig, s.pyramids) for f in dataclasses.fields(part)}


def _rig(shapes):
    """Cameras of mixed odd sizes (one of them gray) around the origin."""
    from pais_mvs_tpu_torch.models.camera import CameraParams
    params, images = [], []
    for i, shape in enumerate(shapes):
        a = 0.2 * i
        params.append(CameraParams(
            file_name=f"c{i}.png", focal=np.array([150.0, 150.0]),
            principal=np.array([-1.0, -1.0]),
            quaternion=np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0]),
            center=np.array([np.sin(a), 0.0, -np.cos(a)]) * 2.0))
        img = _image(shape, 10 + i)
        images.append(img[..., 1] if i == 2 else img)
    return params, images


@pytest.mark.parametrize("ratio,radius", [(0.8, 3), (0.5, 15)])
def test_build_scene_odd_sizes_bit_equal(ratio, radius):
    params, images = _rig([(97, 131), (240, 180), (97, 131), (240, 180)])
    kw = dict(patch_radius=radius, lod_ratio=ratio, max_lod=8)
    want = _scene_bits(jax.device_get(j_build(params, images, JCfg(**kw))))
    got = _scene_bits(t_build(params, images, TCfg(**kw), device="cpu"))
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_view_block_build_equals_block_of_full_scene():
    params, images = _rig([(97, 131), (240, 180), (97, 131), (240, 180)])
    cfg = TCfg(patch_radius=3, lod_ratio=0.8, max_lod=8)
    full = t_build(params, images, cfg, device="cpu")
    split = {}
    for index in range(2):
        part = t_build(params, images, cfg, device="cpu",
                       view_block=(index, 2), split=split)
        want, got = (_scene_bits(full.view_block(index, 2)),
                     _scene_bits(part))
        for k in want:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    assert set(split) == {"undistort_s", "upload_s", "kernel_s"}
    assert all(v >= 0 for v in split.values())
