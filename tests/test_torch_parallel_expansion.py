"""PyTorch port: the SPMD expansion step (``parallel/expansion.py``)
against the JAX package's on the CPU.

  * ``_run_rank``, ``_skip_clauses`` and ``insert_fixpoint``: bit-equal to
    JAX's on tests/test_insert_fixpoint.py's 12 randomised scenarios and
    its chain case (and to its serial simulation);
  * ``build_occupancy``: bit-equal on a refined small arena;
  * ``expand_step`` with the refine replaced in both packages by one
    deterministic stand-in (``torch_view_worker.refine_stub`` and its jnp
    twin here): all seven outputs bit-equal to JAX's ``expand_step`` on
    ``make_mesh((S, 1))``, at S = 1 (a gloo world of one, in this process)
    and S = 4 (four gloo ranks, tests/torch_view_worker.py);
  * ``expand_step`` with the real refine and JAX's per-shard PSO draws
    (``fold_in(key, k)``) injected, at S = 1 and 4 against JAX's (S, 1),
    and view-sharded on a (2, 2) mesh of the 4-camera scene against JAX's
    (2, 1) (tests/test_view_fitness.py::test_expand_distributed_view_
    sharded's pair): the same rows, accepted sets agree >= 0.95 and the
    centres <= 1e-4 at the median over rows both accept
    (tests/test_torch_lifecycle.py's bars: XLA's fused multiply-adds move
    the fitness's last bits, which the PSO amplifies); the view ranks of a
    patch slice return the same bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.models.camera import build_scene as j_build
from pais_mvs_tpu.ops import lifecycle as jlc
from pais_mvs_tpu.parallel import expansion as JX
from pais_mvs_tpu.parallel.mesh import make_mesh as j_make_mesh
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.convert import scene_from_numpy
from pais_mvs_tpu_torch.parallel import expansion as TX
from pais_mvs_tpu_torch.parallel.mesh import world_mesh
from test_insert_fixpoint import _random_scenario, serial_insert_sim
from torch_parity import concat_draws, refine_draws
from torch_view_worker import expand_step_case, run_workers

# ---------------------------------------------------------------------------
# the fixpoint and its pieces
# ---------------------------------------------------------------------------


def _chain_scenario():
    """tests/test_insert_fixpoint.py::test_fixpoint_unblocks_chain's two
    candidates: c0 rejected by its own full cell, so c1 must insert."""
    nrm = np.array([0.0, 0.0, 1.0], np.float32)
    return dict(
        a_acc=np.array([True, True]), a_vis=np.ones((2, 1), bool),
        a_cm=np.ones((2, 1), bool), a_ord=np.array([0.0, 1.0], np.float32),
        a_st=np.stack([np.r_[0, 0, 0, nrm, 0.99].astype(np.float32),
                       np.r_[5, 5, 5, nrm, 0.0].astype(np.float32)]),
        a_ocell=np.array([1, 0], np.int32), a_cnt0=np.array([2, 0], np.int32),
        a_pc=np.zeros((2, 3), np.float32), a_pn=np.tile(nrm, (2, 1)),
        a_cx=np.array([[0], [1]], np.int32), a_cy=np.zeros((2, 1), np.int32),
        cnt_vis=np.zeros((2, 1), np.int32), cap=2, min_corr=0.7, nr=0.1,
        C=1, grid_h=4)


ARGS = ("a_acc", "a_vis", "a_cm", "a_ord", "a_st", "a_ocell", "a_cnt0",
        "a_pc", "a_pn", "a_cx", "a_cy", "cnt_vis")


@pytest.mark.parametrize("seed", list(range(12)) + ["chain"])
def test_fixpoint_pieces_bit_equal(seed):
    if seed == "chain":
        sc = _chain_scenario()
        want = np.array([False, True])
    else:
        rng = np.random.default_rng(seed)
        sc = _random_scenario(rng, SR=96, C=3, grid_w=5, grid_h=4,
                              cap=int(rng.integers(1, 5)))
        sc.update(C=3, grid_h=4)
        want = serial_insert_sim(
            *(sc[k] for k in ("a_acc", "a_vis", "a_cm", "a_ord", "a_st",
                              "a_ocell", "a_cnt0", "a_pc", "a_pn",
                              "vis_cell", "cnt_vis")),
            sc["cap"], sc["min_corr"], sc["nr"])
    tail = (sc["C"], sc["grid_h"], sc["cap"], sc["min_corr"])
    j = np.asarray(JX.insert_fixpoint(
        *(jnp.asarray(sc[k]) for k in ARGS), *tail, jnp.float32(sc["nr"])))
    t = TX.insert_fixpoint(*(torch.from_numpy(sc[k]) for k in ARGS), *tail,
                           float(np.float32(sc["nr"]))).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, want)

    # _run_rank on the scenario's cells (collision-heavy, sentinel rows)
    # keyed by its serial order, each candidate once per camera
    cells = np.where(sc["a_vis"], (sc["a_cx"] * sc["C"]
                                   + np.arange(sc["C"])) * sc["grid_h"]
                     + sc["a_cy"], 2 ** 30).reshape(-1).astype(np.int32)
    ords = np.repeat(sc["a_ord"], sc["C"])
    np.testing.assert_array_equal(
        TX._run_rank(torch.from_numpy(cells), torch.from_numpy(ords)).numpy(),
        np.asarray(JX._run_rank(jnp.asarray(cells), jnp.asarray(ords))))

    # _skip_clauses against a random occupancy whose states straddle the
    # correlation gate and the neighbour distance
    rng = np.random.default_rng(100 + (seed if seed != "chain" else 99))
    cap, W, CGH, M = sc["cap"], 5, 12, len(sc["a_pc"])
    occ = rng.integers(0, cap + 2, (W, CGH)).astype(np.int32)
    ost = np.concatenate([
        rng.normal(size=(W, CGH, cap, 3)).astype(np.float32) * 0.15,
        rng.normal(size=(W, CGH, cap, 3)).astype(np.float32),
        rng.uniform(0.5, 0.9, (W, CGH, cap, 1)).astype(np.float32)], -1)
    lcol = rng.integers(0, W, M).astype(np.int64)
    comb = rng.integers(0, CGH, M).astype(np.int64)
    args = (occ, ost, lcol, comb, sc["a_pc"], sc["a_pn"])
    js, jc = JX._skip_clauses(*(jnp.asarray(a) for a in args),
                              jnp.float32(sc["nr"]), cap, sc["min_corr"])
    ts, tc = TX._skip_clauses(*(torch.from_numpy(a) for a in args),
                              float(np.float32(sc["nr"])), cap,
                              sc["min_corr"])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert 0 < int(ts.sum()) < M


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

W, H, C = 160, 120, 4
KW = dict(patch_radius=3, max_lod=2, particle_num=4, max_iteration=4,
          dist_weighting=1.0, cell_size=10, visible_correlation=0.7,
          min_cam_num=3, min_correlation=0.6)
N_PARENTS, CAP, BUDGET = 32, 2, 24


def j_refine_stub(scene, cfg, pb, key, nr, is_seed, rounds,
                  final_filter=True, view_axis=None):
    """The jnp twin of ``torch_view_worker.refine_stub``."""
    c = jnp.round(pb.center * 256.0) / 256.0
    b = jax.lax.bitcast_convert_type(c, jnp.int32)
    h = ((b[:, 0] * 73856093) ^ (b[:, 1] * 19349663)
         ^ (b[:, 2] * 83492791)) & 0x7FFFFFFF
    unit = lambda m: (h % m).astype(jnp.float32) * (1.0 / 1024.0)
    out = pb.replace(center=c, normal_sph=jnp.zeros_like(pb.normal_sph),
                     correlation=unit(1021), fitness=unit(997),
                     priority=unit(1019), valid=pb.valid & (h % 7 != 0))
    return jlc.RefineResult(out, jnp.zeros(pb.center.shape[0], jnp.int32))


def step_inputs(sc, S, seed=0):
    """One round's inputs for S patch shards: 32 parents on the plane
    (normals tilted up to ~0.2 rad, a few invalid), a random occupancy
    whose cellmates straddle every skip clause, and a random cand_done."""
    rng = np.random.default_rng(seed)
    cw, ch = -(-W // KW["cell_size"]), -(-H // KW["cell_size"])
    slab = -(-cw // S)
    CGH = C * ch
    n = N_PARENTS
    nrm = sc.plane_normal + rng.normal(scale=0.1, size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    valid[rng.choice(n, 3, replace=False)] = False
    occ = np.where(rng.random((S * slab, CGH)) < 0.3,
                   rng.integers(1, CAP + 1, (S * slab, CGH)), 0)
    pick = sc.seed_centers[rng.integers(0, len(sc.seed_centers),
                                        (S * slab, CGH, CAP))]
    ost = np.concatenate([
        pick + rng.normal(scale=0.01, size=pick.shape),
        np.broadcast_to(sc.plane_normal, pick.shape),
        rng.uniform(0.3, 0.8, pick.shape[:-1] + (1,))], -1)
    return dict(
        centers=sc.seed_centers[:n].astype(np.float32),
        normals=nrm.astype(np.float32),
        orank=rng.permutation(n).astype(np.float32), valid=valid,
        pmask=sc.seed_cam_masks[:n].copy(), occ=occ.astype(np.int32),
        ost=ost.astype(np.float32),
        cam_cells=np.array([[cw, ch]] * C, np.int32),
        cand_done=rng.random((n, 4 * C)) < 0.1, nr=0.002, slab=slab,
        gh=ch, cap=CAP, R=BUDGET)


@pytest.fixture(scope="module")
def step_setup():
    sc = make_scene(num_cams=C, width=W, height=H, num_seeds=64, seed=5)
    jcfg = JCfg(**KW)
    jscene = j_build(sc.params, sc.images, jcfg)
    tscene = scene_from_numpy(dataclasses.asdict(jax.device_get(jscene)),
                              device="cpu")
    return sc, jcfg, jscene, TCfg(**KW), tscene


KEY = jax.random.PRNGKey(3)


def j_step(jcfg, jscene, inp, S, monkeypatch=None, shape=None):
    """JAX's expand_step on make_mesh(shape or (S, 1)); the stub when
    ``monkeypatch`` is given (the shard_map builder is lru_cached, so the
    cache is cleared around it)."""
    shape = shape or (S, 1)
    mesh = j_make_mesh(shape, jax.devices()[:shape[0] * shape[1]])
    JX._expand_step_fn.cache_clear()
    if monkeypatch is not None:
        monkeypatch.setattr(jlc, "refine_batch", j_refine_stub)
    try:
        out = JX.expand_step(
            jscene, jcfg, *(jnp.asarray(inp[k]) for k in (
                "centers", "normals", "orank", "valid", "pmask", "occ",
                "ost", "cam_cells")), inp["nr"], KEY, mesh, inp["slab"],
            inp["gh"], inp["cap"], inp["R"],
            cand_done=jnp.asarray(inp["cand_done"]))
        out = jax.device_get(out)
    finally:
        if monkeypatch is not None:
            monkeypatch.undo()
        JX._expand_step_fn.cache_clear()
    return out


def port_draws(S, R, cfg):
    """JAX's PSO uniforms of the round: shard k's refine_batch under
    ``fold_in(KEY, k)``, one round, expansion mode (P and T not
    doubled)."""
    return concat_draws([refine_draws(jax.random.fold_in(KEY, k), 1, R,
                                      cfg.particle_num, cfg.max_iteration)
                         for k in range(S)])[0]


def merged(ranks, name, vp=1):
    """The outputs of case ``name`` over the ranks of view index 0 in
    patch order, the occupancy slabs joined."""
    rows = sorted((r for r in ranks if r[f"{name}:index"][1] == 0),
                  key=lambda r: r[f"{name}:index"][0])
    out = {k.split(":", 1)[1]: v for k, v in rows[0].items()
           if k.startswith(name + ":")}
    out["occ"] = np.concatenate([r[f"{name}:occ"] for r in rows])
    out["ost"] = np.concatenate([r[f"{name}:ost"] for r in rows])
    # everything but the slabs is replicated on every rank, view ranks
    # included, bit for bit
    for r in ranks:
        for k, v in r.items():
            if k.startswith(name + ":") and k.split(":", 1)[1] not in (
                    "occ", "ost", "index"):
                np.testing.assert_array_equal(v, rows[0][k], k)
    return out


def assert_step_equal(t, j):
    pb, acc, occ, ost, spilled, sp_par, ref_cand = j
    for f in dataclasses.fields(pb):
        np.testing.assert_array_equal(t[f"b_{f.name}"],
                                      np.asarray(getattr(pb, f.name)),
                                      f.name)
    np.testing.assert_array_equal(t["acc"], acc)
    np.testing.assert_array_equal(t["occ"], occ)
    np.testing.assert_array_equal(t["ost"], ost)
    np.testing.assert_array_equal(t["spilled"], spilled)
    np.testing.assert_array_equal(t["sp_par"], sp_par)
    np.testing.assert_array_equal(t["ref_cand"], ref_cand)
    # the scenario exercises what it should: inserts, drops, spills
    assert 0 < int(acc.sum()) < int(np.asarray(pb.valid).sum()) + 1
    assert int(spilled[0]) > 0 and sp_par.any() and ref_cand.any()
    assert int(occ.sum()) > 0


def assert_refine_agrees(t, j):
    """The same rows refined with the same draws: tests/test_torch_
    lifecycle.py's bars on the accepted sets and centres."""
    jv = np.asarray(j[1])
    tv = t["acc"]
    assert (jv == tv).mean() >= 0.95, (jv.sum(), tv.sum())
    both = jv & tv
    assert both.sum() >= 10, both.sum()
    dc = np.linalg.norm(t["b_center"][both]
                        - np.asarray(j[0].center)[both], axis=-1)
    assert np.median(dc) <= 1e-4, np.median(dc)


def one_rank(tscene, tcfg, inp, **kw):
    """The port's step at S = 1: ``world_mesh`` makes a gloo world of one
    in this process for the call and destroys it after."""
    with world_mesh("cpu") as mesh:
        got = expand_step_case(tscene, tcfg, inp, mesh, **kw)
    assert not dist.is_initialized()
    return got


def test_expand_step_stubbed_bit_equal_s1(step_setup, monkeypatch):
    sc, jcfg, jscene, tcfg, tscene = step_setup
    inp = step_inputs(sc, 1)
    assert_step_equal(one_rank(tscene, tcfg, inp, stub=True),
                      j_step(jcfg, jscene, inp, 1, monkeypatch))


def test_expand_step_real_refine_agrees_s1(step_setup):
    sc, jcfg, jscene, tcfg, tscene = step_setup
    inp = step_inputs(sc, 1)
    want = j_step(jcfg, jscene, inp, 1)
    got = one_rank(tscene, tcfg, inp, draws=port_draws(1, BUDGET, tcfg))
    assert_refine_agrees(got, want)
    for name, i in (("spilled", 4), ("sp_par", 5), ("ref_cand", 6)):
        np.testing.assert_array_equal(got[name], want[i], name)


@pytest.fixture(scope="module")
def four_ranks(step_setup, tmp_path_factory):
    """Four gloo ranks: the stubbed step and the real one on (4, 1), and
    the real one view-sharded on (2, 2)."""
    sc, jcfg, jscene, tcfg, tscene = step_setup
    inputs = {4: step_inputs(sc, 4), 2: step_inputs(sc, 2)}
    cases = {
        "stub41": dict(shape=(4, 1), inputs=4, stub=True),
        "real41": dict(shape=(4, 1), inputs=4, stub=False,
                       draws=port_draws(4, BUDGET, tcfg)),
        "real22": dict(shape=(2, 2), inputs=2, stub=False,
                       draws=port_draws(2, BUDGET, tcfg)),
    }
    ranks = run_workers("expand_step", 4, tmp_path_factory.mktemp("xs4"),
                        dict(scene=tscene, cfg=dataclasses.asdict(tcfg),
                             inputs=inputs, cases=cases))
    return inputs, ranks


def test_expand_step_stubbed_bit_equal_s4(step_setup, four_ranks,
                                          monkeypatch):
    sc, jcfg, jscene, tcfg, tscene = step_setup
    inputs, ranks = four_ranks
    assert_step_equal(merged(ranks, "stub41"),
                      j_step(jcfg, jscene, inputs[4], 4, monkeypatch))


def test_expand_step_real_refine_agrees_s4(step_setup, four_ranks):
    sc, jcfg, jscene, tcfg, tscene = step_setup
    inputs, ranks = four_ranks
    want = j_step(jcfg, jscene, inputs[4], 4)
    got = merged(ranks, "real41")
    assert_refine_agrees(got, want)
    # everything the refine does not decide is the same bits
    for name, i in (("spilled", 4), ("sp_par", 5), ("ref_cand", 6)):
        np.testing.assert_array_equal(got[name], want[i], name)


def test_expand_step_view_sharded_agrees(step_setup, four_ranks):
    """(2, 2): each rank holds two of the four cameras' atlases; against
    JAX's view-replicated (2, 1) on the same draws."""
    sc, jcfg, jscene, tcfg, tscene = step_setup
    inputs, ranks = four_ranks
    got = merged(ranks, "real22")
    assert sorted(tuple(r["real22:index"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert_refine_agrees(got, j_step(jcfg, jscene, inputs[2], 2))


def test_refine_tail_rounds0_equals_rounds1(step_setup):
    """``expand_step`` refines its longest kept prefix and gives the rest
    of the budget, none of it valid, ``refine_batch(rounds=0)``: on every
    row that enters invalid (flagged so, below minCamNum, or with a
    non-finite centre, as a padded candidate's plane intersection can
    be), that must leave every field as one round of the PSO does."""
    from pais_mvs_tpu_torch.models import patch as pm
    from pais_mvs_tpu_torch.ops import geometry as geom
    from pais_mvs_tpu_torch.ops import lifecycle as tlc
    sc, jcfg, jscene, tcfg, tscene = step_setup
    rng = np.random.default_rng(7)
    n = 40
    nrm = sc.plane_normal + rng.normal(scale=0.1, size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    cen = sc.seed_centers[:n].astype(np.float32).copy()
    cen[rng.choice(n, 4, replace=False)] = np.nan
    mask = sc.seed_cam_masks[:n].copy()
    few = rng.choice(n, 6, replace=False)
    mask[few] = False
    mask[few, :2] = True
    valid = rng.random(n) < 0.6
    pb = pm.empty_batch(n, C, "cpu").replace(
        center=torch.tensor(cen),
        normal_sph=geom.normal_to_spherical(
            torch.from_numpy(nrm.astype(np.float32))),
        cam_mask=torch.from_numpy(mask), valid=torch.from_numpy(valid))
    dead = (~valid | (mask.sum(-1) < tcfg.min_cam_num)
            | ~np.isfinite(cen).all(-1))
    one = tlc.refine_batch(tscene, tcfg, pb, 0.002, False, 1,
                           generator=torch.Generator().manual_seed(0)).batch
    zero = tlc.refine_batch(tscene, tcfg, pb, 0.002, False, 0).batch
    a, b = one.numpy(), zero.numpy()
    for name in a:
        np.testing.assert_array_equal(a[name][dead], b[name][dead], name)
    # the round ran: some live rows moved and some stayed accepted
    live = ~dead
    assert 8 <= dead.sum() < n - 8
    assert (a["center"][live] != b["center"][live]).any()
    assert a["valid"][live].any()


def test_build_occupancy_bit_equal(step_setup):
    """On the arena of a refined small seed stage (the port's engine), the
    port's copy against the JAX package's function, at S in {1, 3}."""
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    sc, jcfg, jscene, tcfg, tscene = step_setup
    rec = Reconstructor(sc.params, sc.images,
                        tcfg.replace(seed_refine_rounds=1, batch_size=64),
                        verbose=False, device="cpu")
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    assert rec.refine_seeds() > 20
    rec.arena.delete(rec.arena.live_ids()[:3])         # dead rows skipped
    cw, ch = -(-W // KW["cell_size"]), -(-H // KW["cell_size"])
    cam_cells = np.array([[cw, ch]] * C, np.int32)
    for S in (1, 3):
        slab = -(-cw // S)
        args = (rec.arena, KW["cell_size"], cam_cells, slab, S, ch, 2)
        t_occ, t_ost = TX.build_occupancy(*args)
        j_occ, j_ost = JX.build_occupancy(*args)
        np.testing.assert_array_equal(t_occ, j_occ)
        np.testing.assert_array_equal(t_ost, j_ost)
        assert int(t_occ.max()) > 2                   # cells past the cap
