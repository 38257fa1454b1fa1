"""PyTorch port, the slice end to end on the CPU: NVM-style seeds ->
scene build -> prepare_seeds -> refine_batch (seed mode) -> runtime filter
-> dense seed cloud -> PLY, through the seed-stage ``Reconstructor``; and
bench.py's real-photo quality bar on the port alone.

Quality bars are the JAX package's own (bench.py:187-191 for the pawn-rig
photo scene: > 40% accepted, median surface distance < 2.5e-3); the
Reconstructor's accepted count is held within the JAX engine's on the same
scene (different PSO random streams: +-15% of the seeds)."""

import numpy as np
import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
from pais_mvs_tpu_torch.io.pointcloud import read_ply
from pais_mvs_tpu_torch.models import patch as tpm
from pais_mvs_tpu_torch.models.camera import build_scene
from pais_mvs_tpu_torch.ops import lifecycle as tlc
import torch_parity  # noqa: F401  (one torch thread per worker)

KW = dict(patch_radius=5, max_lod=4, particle_num=8, max_iteration=12,
          batch_size=64, dist_weighting=5.0 / 3.0, seed_refine_rounds=2)


def test_seed_stage_writes_dense_cloud(tiny_scene, tmp_path):
    rec = Reconstructor(tiny_scene.params, tiny_scene.images,
                        MvsConfig(**KW), verbose=False, device="cpu")
    rec.load_seeds(tiny_scene.seed_centers, tiny_scene.seed_cam_masks,
                   tiny_scene.seed_img_points)
    n = rec.refine_seeds()
    B = len(tiny_scene.seed_centers)
    assert n >= 0.8 * B
    assert rec.stats["seed_accepted"] == n
    centers = rec.live_centers()
    assert centers.shape == (n, 3)
    assert np.median(tiny_scene.surface_distance(centers)) < 0.003
    assert rec.neighbor_radius > 0

    path = str(tmp_path / "seed.ply")
    rec.write_ply(path)
    c, nrm, col = read_ply(path)
    np.testing.assert_allclose(c, centers, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=-1), 1.0, atol=1e-6)
    assert col.shape == (n, 3) and np.all((col >= 0) & (col <= 255))


def test_seed_stage_count_near_jax_engine(tiny_scene):
    """Same scene, same config: the port's and the JAX engine's seed stages
    accept nearly the same number of seeds."""
    from pais_mvs_tpu.config import MvsConfig as JCfg
    from pais_mvs_tpu.engine.reconstructor import Reconstructor as JRec
    jrec = JRec(tiny_scene.params, tiny_scene.images, JCfg(**KW),
                verbose=False)
    jrec.load_seeds(tiny_scene.seed_centers, tiny_scene.seed_cam_masks,
                    tiny_scene.seed_img_points)
    nj = jrec.refine_seeds()
    rec = Reconstructor(tiny_scene.params, tiny_scene.images,
                        MvsConfig(**KW), verbose=False, device="cpu")
    rec.load_seeds(tiny_scene.seed_centers, tiny_scene.seed_cam_masks,
                   tiny_scene.seed_img_points)
    nt = rec.refine_seeds()
    assert abs(nt - nj) <= 0.15 * len(tiny_scene.seed_centers), (nt, nj)


def test_chunk_ladder_and_padding(tiny_scene):
    rec = Reconstructor(tiny_scene.params, tiny_scene.images,
                        MvsConfig(**{**KW, "batch_size": 256}),
                        verbose=False, device="cpu")
    assert rec._chunk_sizes(40) == [64]
    assert rec._chunk_sizes(300) == [256, 64]
    assert rec._chunk_sizes(700) == [256, 256, 256]
    pb = tpm.from_seeds(tiny_scene.seed_centers, tiny_scene.seed_cam_masks,
                        tiny_scene.seed_img_points, device="cpu")
    out, its = rec._refine_all(tlc.prepare_seeds(rec.scene, rec.cfg, pb),
                               is_seed=True, rounds=1)
    assert out.capacity == len(tiny_scene.seed_centers) == its.shape[0]
    assert out.valid.any()


def test_realistic_photo_gate_on_port():
    """bench.py's real-photo pawn-rig gate (bench.py:171-191), run through
    the port on the CPU with torch's own generator."""
    from pais_mvs_tpu_torch.data.realistic import make_realistic_scene
    rsc = make_realistic_scene(num_seeds=128, seed=0)
    cfg = MvsConfig(patch_radius=6, max_lod=4, particle_num=8,
                    max_iteration=12, dist_weighting=2.0, cell_size=12,
                    min_cam_num=3, batch_size=128)
    scene = build_scene(rsc.params, rsc.images, cfg, device="cpu")
    Br = (len(rsc.seed_centers) // 8) * 8
    pb = tpm.from_seeds(rsc.seed_centers[:Br], rsc.seed_cam_masks[:Br],
                        rsc.seed_img_points[:Br], device="cpu")
    pb = tlc.prepare_seeds(scene, cfg, pb)
    res = tlc.refine_batch(scene, cfg, pb, 0.01, True, 2,
                           generator=torch.Generator().manual_seed(3))
    keep = res.batch.valid.numpy()
    d = rsc.surface_distance(res.batch.center.numpy()[keep])
    assert keep.sum() > 0.4 * Br, keep.sum()
    assert np.median(d) < 2.5e-3, np.median(d)
