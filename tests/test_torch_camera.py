"""PyTorch port: the scene build (rig + mip-atlas pyramids) against the JAX
package's ``build_scene``, and the state conversion in ``convert.py``.

Tolerances: the atlases (bf16 images/edges/var, uint8 rgb) and the int32
dims/yoff are compared BIT FOR BIT — both packages run the same float64
numpy pyramid code and round to bf16 the same way; the f32 rig arrays too,
since both cast the same float64 arrays to f32."""

import dataclasses
import os

import jax
import numpy as np
import torch

from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.models.camera import build_scene as j_build
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.convert import patch_batch_from_numpy, scene_from_numpy
from pais_mvs_tpu_torch.models.camera import build_scene as t_build
import torch_parity  # noqa: F401  (one torch thread per worker)


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _tbits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _assert_scene_equal(js, ts):
    for part, tpart in (("rig", ts.rig), ("pyramids", ts.pyramids)):
        jpart = getattr(js, part)
        for f in dataclasses.fields(tpart):
            a = _bits(getattr(jpart, f.name))
            b = _tbits(getattr(tpart, f.name))
            assert a.dtype == b.dtype, (part, f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{part}.{f.name}")


def test_build_scene_bit_equal_synthetic(tiny_scene):
    kw = dict(patch_radius=5, max_lod=4)
    js = jax.device_get(j_build(tiny_scene.params, tiny_scene.images,
                                JCfg(**kw)))
    ts = t_build(tiny_scene.params, tiny_scene.images, TCfg(**kw),
                 device="cpu")
    assert ts.pyramids.images.dtype == torch.bfloat16
    assert ts.pyramids.rgb.dtype == torch.uint8
    _assert_scene_equal(js, ts)


def test_build_scene_bit_equal_realistic():
    """The pawn-rig photo scene at bench.py's realistic-gate config."""
    from pais_mvs_tpu.data.realistic import make_realistic_scene
    rsc = make_realistic_scene(num_seeds=16, seed=0)
    kw = dict(patch_radius=6, max_lod=4, particle_num=8, max_iteration=12,
              dist_weighting=2.0, cell_size=12, min_cam_num=3)
    js = jax.device_get(j_build(rsc.params, rsc.images, JCfg(**kw)))
    ts = t_build(rsc.params, rsc.images, TCfg(**kw), device="cpu")
    _assert_scene_equal(js, ts)


def test_realistic_generator_copy_matches():
    """The port's copy of the realistic scene generator gives the JAX
    package's arrays exactly (same numpy code, same seed)."""
    from pais_mvs_tpu.data.realistic import make_realistic_scene as jm
    from pais_mvs_tpu_torch.data.realistic import make_realistic_scene as tm
    import matplotlib
    from pais_mvs_tpu_torch.data.realistic import PHOTO_PATH
    mpl = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                       "sample_data", "grace_hopper.jpg")
    with open(mpl, "rb") as f, open(PHOTO_PATH, "rb") as g:
        assert f.read() == g.read()       # the bundled copy is the same file
    a, b = jm(num_seeds=8, seed=1), tm(num_seeds=8, seed=1)
    for ia, ib in zip(a.images, b.images):
        np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(a.seed_centers, b.seed_centers)
    np.testing.assert_array_equal(a.seed_img_points, b.seed_img_points)


def test_convert_scene_and_patch_batch(tiny_scene, tiny_built):
    """convert.py carries the JAX pytrees across exactly (bf16 as bf16)."""
    from pais_mvs_tpu.models import patch as jpm
    js = jax.device_get(tiny_built)
    ts = scene_from_numpy(dataclasses.asdict(js), device="cpu")
    _assert_scene_equal(js, ts)
    jb = jpm.from_seeds(tiny_scene.seed_centers, tiny_scene.seed_cam_masks,
                        tiny_scene.seed_img_points)
    tb = patch_batch_from_numpy(dataclasses.asdict(jax.device_get(jb)),
                                device="cpu")
    for f in dataclasses.fields(tb):
        np.testing.assert_array_equal(np.asarray(getattr(jb, f.name)),
                                      getattr(tb, f.name).numpy())
    assert tb.cam_mask.dtype == torch.bool


def test_scene_to_device_roundtrip(tiny_built):
    ts = scene_from_numpy(dataclasses.asdict(jax.device_get(tiny_built)),
                          device="cpu")
    moved = ts.to("cpu")
    assert moved.device.type == "cpu"
    assert moved.pyramids.images.dtype == torch.bfloat16
    _assert_scene_equal(jax.device_get(tiny_built), moved)
