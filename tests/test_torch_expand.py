"""PyTorch port: wavefront expansion and the post-filters of
``engine/reconstructor.py`` against the JAX package's engine.

  (a) Host logic, exact. Both engines' device refine is replaced by one
      deterministic numpy refiner (it keeps the candidates a fixed hash of
      their float32 centre picks, moves them off the plane by a hashed
      offset, projects them for ``img_point`` and sets a hashed
      correlation and priority). The arenas (every field, ``alive``,
      ``expanded``, the deleted archive) and every grid cell must then be
      equal bit for bit, for all four strategies, pipelined and serial,
      native and Python; so must the last autosave (.mvs and sidecar).
  (b) The real refine (plain twins on the CPU) on a tiny scene: the four
      strategies complete on the surface (tests/test_strategies.py's bar).
  (c) Cloud parity (slow): at tests/test_oracle_cloud_parity.py's bar
      against the JAX CPU engine and ``OraclePipeline``.
  (d) Pipelined against serial at
      tests/test_engine_e2e.py::test_pipelined_expansion_matches_serial's
      bar, with the device-time stats the port keeps.
  (e) The four post-filters, exact against JAX on a shared arena, native
      and Python.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu import config as jcfg_mod
from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.engine.arena import PatchArena as JArena
from pais_mvs_tpu.engine.reconstructor import Reconstructor as JRec
from pais_mvs_tpu.ops import lifecycle as jlc
from pais_mvs_tpu.oracle import cloud_agreement
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.engine.arena import PatchArena as TArena
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor as TRec
from pais_mvs_tpu_torch.ops import lifecycle as tlc

STRATEGIES = [jcfg_mod.EXPANSION_BEST_FIRST, jcfg_mod.EXPANSION_WORST_FIRST,
              jcfg_mod.EXPANSION_BREADTH_FIRST, jcfg_mod.EXPANSION_DEPTH_FIRST]
W, H = 200, 150
STUB_KW = dict(patch_radius=3, max_lod=2, cell_size=10, min_cam_num=3,
               max_cell_patch_num=2, batch_size=64, wavefront_size=48,
               min_correlation=0.6)


class StubRefiner:
    """The deterministic stand-in for ``refine_batch`` (numpy, float32
    results, no randomness): the same rule for both engines."""

    def __init__(self, rec, min_cam_num):
        self.R, self.c = rec.np_R, rec.np_center
        self.f, self.pp = rec.np_focal, rec.np_principal
        self.min_cam_num = min_cam_num

    def __call__(self, center, normal_sph, cam_mask, valid):
        bits = center.astype(np.float32).view(np.uint32).astype(np.uint64)
        hv = (bits[:, 0] * 73856093 ^ bits[:, 1] * 19349663
              ^ bits[:, 2] * 83492791) % np.uint64(2 ** 31)
        unit = lambda s, m: ((hv >> np.uint64(s)) % np.uint64(m)).astype(
            np.float64) / m
        sph = (normal_sph + 0.02 * (unit(3, 101)[:, None] - 0.5)).astype(
            np.float32)
        st = np.sin(sph[:, 0].astype(np.float64))
        n = np.stack([st * np.cos(sph[:, 1]), st * np.sin(sph[:, 1]),
                      np.cos(sph[:, 0].astype(np.float64))], -1)
        ctr = (center + 2e-3 * (unit(5, 97) - 0.5)[:, None] * n).astype(
            np.float32)
        X = np.einsum("cij,bcj->bci", self.R,
                      ctr.astype(np.float64)[:, None] - self.c[None])
        z = X[..., 2]
        uv = X[..., :2] / np.where(z > 0, z, 1.0)[..., None] * self.f \
            + self.pp
        inside = ((z > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < W)
                  & (uv[..., 1] >= 0) & (uv[..., 1] < H))
        mask = cam_mask & inside
        keep = valid & (mask.sum(1) >= self.min_cam_num) & (hv % 7 != 0)
        ref = np.argmax(mask, axis=1).astype(np.int32)
        B = len(center)
        return dict(
            center=ctr, normal_sph=sph, cam_mask=mask, ref_cam=ref,
            depth=np.linalg.norm(ctr - self.c[ref], axis=-1).astype(
                np.float32),
            lod=np.zeros(B, np.int32),
            fitness=unit(7, 89).astype(np.float32),
            correlation=(0.3 + 0.6 * unit(9, 83)).astype(np.float32),
            priority=unit(11, 1009).astype(np.float32),
            color=np.full((B, 3), 128.0, np.float32),
            img_point=uv.astype(np.float32), valid=keep)


def stub_jax(refiner):
    def refine(scene, cfg, chunk, key, nr, is_seed, rounds,
               final_filter=True):
        out = refiner(*(np.asarray(x) for x in (
            chunk.center, chunk.normal_sph, chunk.cam_mask, chunk.valid)))
        B = len(out["valid"])
        return jlc.RefineResult(
            chunk.replace(**{k: jnp.asarray(v) for k, v in out.items()}),
            jnp.zeros(B, jnp.int32))
    return refine


def stub_port(refiner):
    def refine(scene, cfg, chunk, neighbor_radius, is_seed, rounds,
               final_filter=True, generator=None, draws=None, view=None):
        out = refiner(*(x.cpu().numpy() for x in (
            chunk.center, chunk.normal_sph, chunk.cam_mask, chunk.valid)))
        B = len(out["valid"])
        return tlc.RefineResult(
            chunk.replace(**{k: torch.from_numpy(v) for k, v in out.items()}),
            torch.zeros(B, dtype=torch.int32))
    return refine


@pytest.fixture(scope="module")
def engines():
    """One JAX and one port engine on the same scene (the scene build is
    the costly part), re-armed per case by ``arm``, and the stub."""
    sc = make_scene(num_cams=4, width=W, height=H, num_seeds=25, seed=3)
    jrec = JRec(sc.params, sc.images, JCfg(**STUB_KW), verbose=False)
    trec = TRec(sc.params, sc.images, TCfg(**STUB_KW), verbose=False,
                device="cpu")
    np.testing.assert_array_equal(trec.np_R, jrec.np_R)
    np.testing.assert_array_equal(trec.np_center, jrec.np_center)
    np.testing.assert_array_equal(trec.np_focal, jrec.np_focal)
    np.testing.assert_array_equal(trec.np_principal, jrec.np_principal)
    np.testing.assert_array_equal(trec.np_optical, jrec.np_optical)
    refiner = StubRefiner(jrec, STUB_KW["min_cam_num"])
    B = len(sc.seed_centers)
    # seed normals tilted up to ~50 degrees off the plane's, so that some
    # candidates lack cameras in the viewing cone and take the parent's
    # fallback cameras (Patch::expandVisibleCamera)
    u = np.random.default_rng(0).uniform(size=(B, 2))
    sph = np.stack([np.pi - 0.9 * u[:, 0], 2 * np.pi * u[:, 1]], -1)
    seeds = refiner(sc.seed_centers.astype(np.float32),
                    sph.astype(np.float32), sc.seed_cam_masks,
                    np.ones(B, bool))
    seeds = {k: v[seeds["valid"]] for k, v in seeds.items()}
    del seeds["valid"]
    return sc, jrec, trec, refiner, seeds


def arm(rec, arena_cls, native, seeds, **cfg_kw):
    rec.cfg = rec.cfg.replace(**{**STUB_KW, **cfg_kw})
    rec.use_native = native
    rec.grids = None
    rec.neighbor_radius = rec.cfg.neighbor_radius
    rec.arena = arena_cls(len(rec.params))
    n = len(seeds["center"])
    rec.arena.append(**seeds, is_seed=np.ones(n, bool))
    rec._update_neighbor_radius()


def assert_same_state(trec, jrec):
    ta, ja = trec.arena, jrec.arena
    assert ta.count == ja.count
    n = ta.count
    np.testing.assert_array_equal(ta.alive[:n], ja.alive[:n])
    np.testing.assert_array_equal(ta.expanded[:n], ja.expanded[:n])
    assert list(ta.deleted_ids) == list(ja.deleted_ids)
    for k in ja.data:
        np.testing.assert_array_equal(ta.data[k][:n], ja.data[k][:n], k)
    assert trec.neighbor_radius == jrec.neighbor_radius
    keys = ja.live_ids()
    cells = lambda g: {k: list(g.cell(*k)) for k in g.all_keys()}
    assert cells(trec.grids) == cells(jrec.grids)
    assert len(keys) > 0


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_expand_host_logic_is_bit_equal(engines, monkeypatch, tmp_path,
                                        strategy, pipeline, native):
    """... and the last autosave (every 60 new patches; under pipelining
    the in-flight parents are saved unexpanded) holds the same bytes."""
    sc, jrec, trec, refiner, seeds = engines
    monkeypatch.setattr(jlc, "refine_batch", stub_jax(refiner))
    monkeypatch.setattr(tlc, "refine_batch", stub_port(refiner))
    kw = dict(expansion_strategy=strategy, pipeline_expansion=pipeline)
    saves = {}
    for name, rec, cls in (("jax", jrec, JArena), ("port", trec, TArena)):
        arm(rec, cls, native, seeds, **kw)
        monkeypatch.setattr(rec, "autosave_interval", 60, raising=False)
        saves[name] = str(tmp_path / f"{name}.mvs")
    n0 = trec.arena.count
    nj = jrec.expand(max_rounds=7, autosave_path=saves["jax"])
    nt = trec.expand(max_rounds=7, autosave_path=saves["port"])
    assert nt == nj > 2 * n0, (nt, nj, n0)
    assert trec.stats["expansion_refined"] == \
        jrec.stats["expansion_refined"]
    assert_same_state(trec, jrec)
    with open(saves["port"], "rb") as t, open(saves["jax"], "rb") as j:
        assert t.read() == j.read()
    tst, jst = (np.load(saves[k] + ".state.npz") for k in ("port", "jax"))
    assert sorted(tst.files) == sorted(jst.files)
    for k in jst.files:
        np.testing.assert_array_equal(tst[k], jst[k], k)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_post_filters_exact_on_shared_arena(engines, monkeypatch, native):
    """The four -f filters in the CLI's order on the arena a stubbed
    expansion left (the grids rebuilt from it, as -f does): equal
    removals, alive set, deleted archive and grid after each filter."""
    sc, jrec, trec, refiner, seeds = engines
    monkeypatch.setattr(jlc, "refine_batch", stub_jax(refiner))
    monkeypatch.setattr(tlc, "refine_batch", stub_port(refiner))
    for rec, cls in ((jrec, JArena), (trec, TArena)):
        arm(rec, cls, native, seeds, visible_correlation=0.5)
        rec.expand(max_rounds=12)
        rec.grids = None
    removed = 0
    for name, args in (("cell_filtering", ()), ("visibility_filtering", ()),
                       ("neighbor_cell_filtering", (0.25,)),
                       ("neighbor_patch_filtering", (0.25,))):
        if name == "neighbor_patch_filtering":
            for rec in (jrec, trec):
                rec.arena.deleted_ids.clear()
        r = getattr(trec, name)(*args)
        assert r == getattr(jrec, name)(*args), name
        removed += r
        assert_same_state(trec, jrec)
    assert removed > 0


def tiny_port_run(strategy):
    cfg = TCfg(patch_radius=4, max_lod=3, particle_num=6, max_iteration=6,
               dist_weighting=4 / 3.0, seed_refine_rounds=1, cell_size=12,
               batch_size=64, wavefront_size=8, expansion_strategy=strategy)
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=20, seed=2)
    rec = TRec(sc.params, sc.images, cfg, verbose=False, device="cpu")
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    return sc, rec


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_expansion_strategies_complete(strategy):
    """tests/test_strategies.py's run through the port's real refine."""
    sc, rec = tiny_port_run(strategy)
    n_seeds = rec.refine_seeds()
    assert n_seeds > 5
    total = rec.expand(max_rounds=6)
    assert total >= n_seeds
    assert total > n_seeds, "expansion added nothing"
    d = sc.surface_distance(rec.live_centers())
    assert np.median(d) < 0.01
    s = rec.stats
    assert s["expansion_refined"] > 0
    assert 0 < s["expansion_device_s"] <= s["expansion_s"] + 1e-3


# tests/test_oracle_cloud_parity.py's and test_engine_e2e.py's scene
PARITY_KW = dict(patch_radius=4, max_lod=3, particle_num=6, max_iteration=8,
                 dist_weighting=4 / 3.0, cell_size=10, min_cam_num=3,
                 max_cell_patch_num=2, neighbor_radius_scalar=0.08,
                 batch_size=64, wavefront_size=64, seed_refine_rounds=1)


def parity_port_run(sc, **kw):
    rec = TRec(sc.params, sc.images, TCfg(**PARITY_KW, **kw), verbose=False,
               device="cpu")
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    rec.refine_seeds()
    rec.expand()
    return rec


def half_cell(sc, rec):
    """Half a cell's world footprint at the scene's depth."""
    depth = float(np.linalg.norm(sc.seed_centers.mean(0)
                                 - rec.np_center.mean(0)))
    return 0.5 * PARITY_KW["cell_size"] * depth / float(rec.np_focal[0, 0])


@pytest.mark.slow
def test_cloud_matches_jax_engine_and_oracle():
    from pais_mvs_tpu.oracle import OraclePipeline
    sc = make_scene(num_cams=4, width=200, height=150, num_seeds=25, seed=3)
    rec = parity_port_run(sc)
    pts = rec.live_centers()
    assert np.median(sc.surface_distance(pts)) < 0.005
    jrec = JRec(sc.params, sc.images, JCfg(**PARITY_KW), verbose=False)
    jrec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                    np.full((len(sc.seed_centers), 3), 128.0))
    jrec.refine_seeds()
    jrec.expand()
    orc = OraclePipeline(sc.params, sc.images, JCfg(**PARITY_KW), seed=0)
    orc.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points)
    orc.refine_seeds()
    orc.expand(max_patches=3000)
    tol = half_cell(sc, rec)
    for ref in (jrec.live_centers(), orc.cloud()):
        assert len(ref) > 150
        ag = cloud_agreement(pts, ref, tol)
        assert ag["engine_within_tol"] >= 0.90, ag
        assert ag["oracle_within_tol"] >= 0.90, ag
        assert 0.75 <= ag["engine_count"] / ag["oracle_count"] <= 1.33, ag


def test_pipelined_expansion_matches_serial():
    sc = make_scene(num_cams=4, width=200, height=150, num_seeds=25, seed=3)
    rec_s = parity_port_run(sc)
    rec_p = parity_port_run(sc, pipeline_expansion=True)
    spts, ppts = rec_s.live_centers(), rec_p.live_centers()
    assert len(ppts) > 150, len(ppts)
    assert np.median(sc.surface_distance(ppts)) < 0.005
    assert (~rec_p.arena.expanded[rec_p.arena.live_ids()]).sum() == 0
    ag = cloud_agreement(ppts, spts, half_cell(sc, rec_s))
    assert ag["engine_within_tol"] >= 0.9, ag
    assert ag["oracle_within_tol"] >= 0.9, ag
    assert 0.8 <= len(ppts) / len(spts) <= 1.25, (len(ppts), len(spts))
    for rec in (rec_s, rec_p):
        s = rec.stats
        assert 0 < s["expansion_device_s"] <= s["expansion_s"] + 1e-3
        assert s["expansion_host_s"] == round(
            s["expansion_s"] - s["expansion_device_s"], 3)
