"""PyTorch port: the engine's multi-rank paths on the CPU, in gloo worker
processes (tests/torch_view_worker.py):

  * ``_chunk_sizes``: the JAX engine's ladder for dp in {1, 2, 3, 6};
  * ``_refine_dp`` at dp = 2 with JAX's per-shard PSO draws against the
    JAX engine's ``_refine_dp`` over a 2-device mesh, at
    tests/test_torch_lifecycle.py's bars (valid agreement >= 0.95,
    accepted counts within +-2, median centre difference <= 1e-4: XLA's
    fused multiply-adds move the fitness's last bits, which the PSO
    amplifies); both ranks return the same bits;
  * ``expand_distributed`` at S = 4 on tests/test_engine_distributed.py's
    oracle scene: every rank's arena bit-equal; the drained cloud against
    the serial oracle at that test's bars (>= 0.90 mutual agreement at
    half a cell, count ratio in [0.75, 1.33]); strategies 1-3 grow on the
    surface; a spilling run (refine budget 8) stopped after three rounds,
    checkpointed, resumed in a fresh Reconstructor with its ``cand_done``
    record intact, drains to >= 0.85 of the unconstrained cloud;
  * ``slow`` (~400 s on one CPU thread): the pawn-rig photo scene's
    realistic-parity test through the port, at the JAX test's relative
    and absolute bars.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.engine.reconstructor import Reconstructor as JRec
from pais_mvs_tpu.oracle import OraclePipeline, cloud_agreement
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.convert import scene_from_numpy
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor as TRec
from pais_mvs_tpu_torch.models.camera import CameraParams as TParams
from torch_parity import concat_draws, refine_draws
from torch_view_worker import run_workers


def port_params(params):
    """The JAX scene's cameras as the port's CameraParams: what the ranks
    unpickle must not import JAX."""
    return [TParams(**dataclasses.asdict(p)) for p in params]


class _Axis:
    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("dp", [1, 2, 3, 6])
def test_chunk_sizes_match_jax(dp):
    for bs in (64, 96, 256, 1024):
        j = JRec.__new__(JRec)
        j.cfg = JCfg(batch_size=bs)
        j._dp_mesh = None if dp == 1 else _Axis(dp)
        t = TRec.__new__(TRec)
        t.cfg = TCfg(batch_size=bs)
        t._dp = None if dp == 1 else _Axis(dp)
        for B in (1, 17, 64, 100, 400, 1000, 3000):
            sizes = t._chunk_sizes(B)
            assert sizes == j._chunk_sizes(B), (bs, B)
            assert sum(sizes) >= B
            # the engine turns dp on only for a batch size dp divides
            if bs % dp == 0:
                assert all(s % dp == 0 for s in sizes), (bs, B, sizes)


DP_KW = dict(patch_radius=4, max_lod=3, particle_num=4, max_iteration=4,
             dist_weighting=4 / 3.0, batch_size=64)


def test_refine_dp_matches_jax(tmp_path):
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=72, seed=4)
    jcfg = JCfg(**DP_KW, data_parallel="off")
    jrec = JRec(sc.params, sc.images, jcfg, verbose=False)
    jrec._dp_mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    B = len(sc.seed_centers) // 2 * 2
    jrec.load_seeds(sc.seed_centers[:B], sc.seed_cam_masks[:B],
                    sc.seed_img_points[:B])
    chunk = jrec._seed_pb
    nr, rounds = 0.005, 1
    jrec.neighbor_radius = nr
    key = jax.random.PRNGKey(11)
    jres = jax.device_get(jrec._refine_dp(
        jax.tree.map(jnp.asarray, chunk), key, True, rounds, True))
    P, T = 2 * DP_KW["particle_num"], 2 * DP_KW["max_iteration"]
    draws = concat_draws([refine_draws(jax.random.fold_in(key, k), rounds,
                                       B // 2, P, T) for k in range(2)])
    ranks = run_workers("refine_dp", 2, tmp_path, dict(
        cfg=dataclasses.asdict(TCfg(**DP_KW, data_parallel="on")),
        params=port_params(sc.params), images=sc.images,
        scene=scene_from_numpy(dataclasses.asdict(
            jax.device_get(jrec.scene)), device="cpu"),
        chunk=dataclasses.asdict(chunk), nr=nr, rounds=rounds, draws=draws))
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(ranks[1][k], v, k)
    t = ranks[0]
    assert bool(t["dp"])
    # the dp ladder: sizes divide over the two ranks
    assert list(t["chunks"]) == [64] * 16
    jv, tv = np.asarray(jres.batch.valid), t["b_valid"]
    assert (jv == tv).mean() >= 0.95, (jv.sum(), tv.sum())
    assert abs(int(jv.sum()) - int(tv.sum())) <= 2
    both = jv & tv
    assert both.sum() >= 0.5 * B
    dc = np.linalg.norm(t["b_center"][both]
                        - np.asarray(jres.batch.center)[both], axis=-1)
    assert np.median(dc) <= 1e-4, np.median(dc)
    assert np.median(sc.surface_distance(t["b_center"][tv])) < 0.003


# tests/test_engine_distributed.py::test_expand_distributed_matches_
# serial_oracle's scene and configuration
ORACLE_KW = dict(patch_radius=4, max_lod=3, particle_num=6, max_iteration=8,
                 dist_weighting=4 / 3.0, cell_size=10, min_cam_num=3,
                 max_cell_patch_num=2, neighbor_radius_scalar=0.08,
                 batch_size=64, seed_refine_rounds=1)
STRATEGIES = (1, 2, 3)


@pytest.fixture(scope="module")
def oracle_scene():
    return make_scene(num_cams=4, width=200, height=150, num_seeds=25, seed=3)


@pytest.fixture(scope="module")
def dist_ranks(oracle_scene, tmp_path_factory):
    sc = oracle_scene
    d = tmp_path_factory.mktemp("dist4")
    seeds = (sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
             np.full((len(sc.seed_centers), 3), 128.0))
    return run_workers("expand_distributed", 4, d, dict(
        cfg=dataclasses.asdict(TCfg(**ORACLE_KW)),
        params=port_params(sc.params),
        images=sc.images, seeds=seeds, strategies=STRATEGIES, dir=str(d)),
        timeout_s=240)


def live(ranks, name):
    r = ranks[0]
    return r[f"{name}:d_center"][r[f"{name}:alive"]]


def test_ranks_hold_bit_equal_arenas(dist_ranks):
    for r in dist_ranks[1:]:
        assert sorted(r) == sorted(dist_ranks[0])
        for k, v in r.items():
            np.testing.assert_array_equal(v, dist_ranks[0][k], k)


def test_drained_cloud_matches_serial_oracle(oracle_scene, dist_ranks):
    sc = oracle_scene
    orc = OraclePipeline(sc.params, sc.images, JCfg(**ORACLE_KW), seed=0)
    orc.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points)
    orc.refine_seeds()
    orc.expand(max_patches=3000)
    opts = orc.cloud()
    assert len(opts) > 150, "oracle reconstruction degenerate"
    epts = live(dist_ranks, "drained")
    r = dist_ranks[0]
    assert (~r["drained:expanded"][r["drained:alive"]]).sum() == 0
    assert np.median(sc.surface_distance(epts)) < 0.005
    cams = np.array([p.center for p in sc.params], float)
    depth = float(np.linalg.norm(sc.seed_centers.mean(0) - cams.mean(0)))
    half_cell = 0.5 * ORACLE_KW["cell_size"] * depth / float(
        sc.params[0].focal[0])
    ag = cloud_agreement(epts, opts, half_cell)
    assert ag["engine_within_tol"] >= 0.90, ag
    assert ag["oracle_within_tol"] >= 0.90, ag
    assert 0.75 <= ag["engine_count"] / ag["oracle_count"] <= 1.33, ag


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategies_grow_on_surface(oracle_scene, dist_ranks, strategy):
    n_seeds = int(dist_ranks[0]["n_seeds"])
    pts = live(dist_ranks, f"strategy{strategy}")
    assert len(pts) > n_seeds + 20, (len(pts), n_seeds)
    assert np.median(oracle_scene.surface_distance(pts)) < 0.01


def test_spilled_candidates_are_requeued(oracle_scene, dist_ranks):
    """A refine budget of 8 per rank spills every round; the parents are
    re-queued and the resumed run drains the frontier to the
    unconstrained cloud's size."""
    r = dist_ranks[0]
    assert r["stopped:stats"][0] > 0, "budget did not force spill"
    n_s = len(live(dist_ranks, "resumed"))
    n_u = len(live(dist_ranks, "drained"))
    assert n_s >= 0.85 * n_u, (n_s, n_u)
    assert (~r["resumed:expanded"][r["resumed:alive"]]).sum() == 0
    assert np.median(oracle_scene.surface_distance(
        live(dist_ranks, "resumed"))) < 0.01


def test_checkpoint_resume_keeps_cand_done(dist_ranks):
    r = dist_ranks[0]
    assert len(r["stopped_cand_done"]) > 0
    np.testing.assert_array_equal(r["loaded_cand_done"],
                                  r["stopped_cand_done"])
    np.testing.assert_array_equal(r["loaded_cand_masks"],
                                  r["stopped_cand_masks"])
    for k in [k for k in r if k.startswith("stopped:") and ":d_" in k]:
        np.testing.assert_array_equal(r[k.replace("stopped", "loaded")],
                                      r[k], k)
    assert r["resumed:d_center"].shape[0] > r["stopped:d_center"].shape[0]


@pytest.mark.slow
def test_expand_distributed_realistic_parity():
    """tests/test_engine_distributed.py::test_expand_distributed_
    realistic_parity through the port on the pawn-rig photo scene: the
    host expansion at wavefront 128 and 32 (the host's own order-
    sensitivity yardstick) and ``expand_distributed`` in a world of one
    with 256 parents per round (the JAX test's 8 shards x 32). The
    distributed cloud must agree with the host's within 8 points of the
    yardstick and never below 0.65, at a count ratio in [0.7, 1.43]."""
    from pais_mvs_tpu_torch.data.realistic import make_realistic_scene
    sc = make_realistic_scene(num_seeds=60, seed=0)
    base = dict(patch_radius=6, max_lod=4, particle_num=8,
                max_iteration=12, dist_weighting=2.0, cell_size=12,
                min_cam_num=3, max_cell_patch_num=2,
                neighbor_radius_scalar=0.01, batch_size=128,
                seed_refine_rounds=2)

    def build(wavefront):
        rec = TRec(sc.params, sc.images, TCfg(**base,
                                              wavefront_size=wavefront),
                   verbose=False, device="cpu")
        rec.load_seeds(sc.seed_centers, sc.seed_cam_masks,
                       sc.seed_img_points,
                       np.full((len(sc.seed_centers), 3), 128.0))
        rec.refine_seeds()
        return rec

    rec_h = build(128)
    rec_h.expand(max_rounds=120)
    rec_y = build(32)
    rec_y.expand(max_rounds=120)
    rec_d = build(128)
    rec_d.expand_distributed(max_rounds=160, per_shard=256)
    hpts, ypts, dpts = (r.live_centers() for r in (rec_h, rec_y, rec_d))
    assert len(hpts) > 150 and len(dpts) > 150, (len(hpts), len(dpts))
    assert np.median(sc.surface_distance(hpts)) < 0.005
    assert np.median(sc.surface_distance(dpts)) < 0.005
    depth = float(np.linalg.norm(sc.seed_centers.mean(0)
                                 - rec_h.np_center.mean(0)))
    tol = 0.5 * base["cell_size"] * depth / float(rec_h.np_focal[0, 0])
    ag_d = cloud_agreement(dpts, hpts, tol)
    ag_y = cloud_agreement(ypts, hpts, tol)
    yard = min(ag_y["engine_within_tol"], ag_y["oracle_within_tol"])
    got = min(ag_d["engine_within_tol"], ag_d["oracle_within_tol"])
    assert got >= yard - 0.08, (got, yard, ag_d, ag_y)
    assert got >= 0.65, (got, ag_d)
    assert 0.7 <= ag_d["engine_count"] / ag_d["oracle_count"] <= 1.43, ag_d
