"""PyTorch port: file formats and checkpoints against the JAX package.

  * the ``.mvs``, ``.ply`` and ``.psr`` writers are byte-identical to the
    JAX package's for the same patch data, and each package reads the
    other's files to the same values;
  * NVM and NVM2: the same bytes written, the same values read back;
  * the port's checkpoint (``.mvs`` + ``.state.npz`` sidecar) round-trips
    the whole arena and resumes expansion; a corrupt sidecar is refused
    without touching the arena;
  * a sidecar written by the JAX engine mid-expansion loads into the port,
    which resumes the expansion from it.
"""

import dataclasses

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.engine.reconstructor import Reconstructor as JRec
from pais_mvs_tpu.io import mvsbin as jmvs
from pais_mvs_tpu.io import nvm as jnvm
from pais_mvs_tpu.io import pointcloud as jpc
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor as TRec
from pais_mvs_tpu_torch.io import mvsbin as tmvs
from pais_mvs_tpu_torch.io import nvm as tnvm
from pais_mvs_tpu_torch.io import pointcloud as tpc
from pais_mvs_tpu_torch.models.camera import CameraParams as TCam

KW = dict(patch_radius=4, max_lod=3, particle_num=6, max_iteration=6,
          dist_weighting=4 / 3.0, seed_refine_rounds=1, cell_size=10,
          batch_size=64, wavefront_size=64)


@pytest.fixture(scope="module")
def sc():
    return make_scene(num_cams=4, width=160, height=120, num_seeds=30, seed=9)


def port_cams(params):
    return [TCam(**dataclasses.asdict(p)) for p in params]


def seeded_port(sc):
    rec = TRec(sc.params, sc.images, TCfg(**KW), verbose=False,
               device="cpu")
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    rec.refine_seeds()
    return rec


def assert_arenas_equal(a1, a2):
    assert a1.count == a2.count
    n = a1.count
    np.testing.assert_array_equal(a1.alive[:n], a2.alive[:n])
    np.testing.assert_array_equal(a1.expanded[:n], a2.expanded[:n])
    assert list(a1.deleted_ids) == list(a2.deleted_ids)
    assert set(a1.data) == set(a2.data)
    for k in a1.data:
        np.testing.assert_array_equal(a1.data[k][:n], a2.data[k][:n], k)


def test_writers_are_byte_identical(sc, tmp_path):
    rng = np.random.default_rng(0)
    M, C = 23, 4
    patches = dict(centers=rng.normal(size=(M, 3)),
                   normal_sph=rng.uniform(0, 3, size=(M, 2)),
                   cam_masks=rng.uniform(size=(M, C)) > 0.4,
                   fitness=rng.uniform(size=M),
                   correlation=rng.uniform(size=M))
    kw = dict(patch_radius=9, lod_ratio=0.75, particle_num=11,
              expansion_strategy=2, min_correlation=0.61)
    jp, tp = tmp_path / "j.mvs", tmp_path / "t.mvs"
    jmvs.write_mvs(str(jp), JCfg(**kw), sc.params,
                   jmvs.MvsPatchData(**patches))
    tmvs.write_mvs(str(tp), TCfg(**kw), port_cams(sc.params),
                   tmvs.MvsPatchData(**patches))
    assert tp.read_bytes() == jp.read_bytes()
    f = tmvs.read_mvs(str(jp))
    assert f.config == TCfg(**kw)
    assert [c.file_name for c in f.cameras] == \
        [p.file_name for p in sc.params]
    for name, want in patches.items():
        np.testing.assert_array_equal(getattr(f.patches, name), want)

    normals = rng.normal(size=(M, 3))
    colors = rng.integers(0, 255, size=(M, 3)).astype(np.float64)
    for ext, jw, tw, args in (
            ("ply", jpc.write_ply, tpc.write_ply,
             (patches["centers"], normals, colors)),
            ("psr", jpc.write_psr, tpc.write_psr,
             (patches["centers"], normals))):
        jw(str(tmp_path / f"j.{ext}"), *args)
        tw(str(tmp_path / f"t.{ext}"), *args)
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes(), ext


@pytest.mark.parametrize("nvm2", [False, True])
def test_nvm_round_trip_matches_jax(sc, tmp_path, nvm2):
    params = sc.params
    if nvm2:    # anisotropic focal + explicit principal point
        params = [dataclasses.replace(
            p, focal=np.array([p.focal[0], p.focal[0] * 1.02]),
            principal=np.array([77.0, 55.0])) for p in params]
    ipts = sc.seed_img_points.copy()
    ipts[..., 0] -= 160 // 2
    ipts[..., 1] -= 120 // 2
    args = (sc.seed_centers, sc.seed_colors, sc.seed_cam_masks, ipts)
    jp, tp = tmp_path / "j.nvm", tmp_path / "t.nvm"
    jnvm.save_nvm(str(jp), params, *args, nvm2=nvm2)
    tnvm.save_nvm(str(tp), port_cams(params), *args, nvm2=nvm2)
    assert tp.read_bytes() == jp.read_bytes()
    j = jnvm.load_nvm(str(jp), nvm2=nvm2)
    t = tnvm.load_nvm(str(jp), nvm2=nvm2)
    assert [dataclasses.asdict(c).keys() for c in t.cameras] == \
        [dataclasses.asdict(c).keys() for c in j.cameras]
    for tc, jc in zip(t.cameras, j.cameras):
        for k, v in dataclasses.asdict(jc).items():
            np.testing.assert_array_equal(getattr(tc, k), v, k)
    for name in ("centers", "colors", "cam_masks", "img_points"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    back = tnvm.decenter_image_points(t, [160] * 4, [120] * 4)
    np.testing.assert_array_equal(
        back, jnvm.decenter_image_points(j, [160] * 4, [120] * 4))
    sel = sc.seed_cam_masks
    np.testing.assert_allclose(back[sel], sc.seed_img_points[sel],
                               atol=1e-4)


def test_checkpoint_round_trip_and_resume(sc, tmp_path):
    rec = seeded_port(sc)
    rec.expand(max_rounds=2)                  # interrupt mid-expansion
    rec._dist_cand_done = {2: np.eye(16, dtype=bool)[3]}
    ck = str(tmp_path / "auto_save.mvs")
    rec.save_checkpoint(ck)

    rec2 = TRec(sc.params, sc.images, TCfg(**KW), verbose=False,
                device="cpu")
    assert rec2.load_checkpoint(ck)
    assert_arenas_equal(rec.arena, rec2.arena)
    assert rec2.neighbor_radius == rec.neighbor_radius
    assert set(rec2._dist_cand_done) == {2}
    np.testing.assert_array_equal(rec2._dist_cand_done[2],
                                  rec._dist_cand_done[2])
    a = rec2.arena
    assert int((~a.expanded[:a.count] & a.alive[:a.count]).sum()) > 0
    n_before = len(a.live_ids())
    rec2.expand(max_rounds=50)
    assert len(a.live_ids()) >= n_before
    assert int((~a.expanded[:a.count] & a.alive[:a.count]).sum()) == 0
    assert np.median(sc.surface_distance(rec2.live_centers())) < 0.01
    assert not rec2.load_checkpoint(str(tmp_path / "nope.mvs"))


def test_corrupt_sidecar_leaves_arena_untouched(sc, tmp_path):
    """A sidecar that opens but has a bad member is refused, reported,
    and the arena stays as it was (the fall-back-to-.mvs contract)."""
    from pais_mvs_tpu_torch.io.logmanager import LogManager
    rec = seeded_port(sc)
    ck = str(tmp_path / "auto_save.mvs")
    rec.save_checkpoint(ck)
    st = dict(np.load(ck + ".state.npz"))
    st["d_center"] = st["d_center"][:3]        # wrong row count
    np.savez_compressed(ck + ".state.npz", **st)

    log = tmp_path / "log.txt"
    rec2 = TRec(sc.params, sc.images, TCfg(**KW), verbose=False,
                device="cpu", logger=LogManager(str(log), echo=False))
    before = rec2.arena.count
    assert not rec2.load_checkpoint(ck)
    assert rec2.arena.count == before
    assert "ignoring corrupt checkpoint sidecar" in log.read_text()


def test_jax_checkpoint_resumes_in_port(sc, tmp_path):
    """The JAX engine writes auto_save.mvs and its sidecar mid-expansion;
    the port reads both with its own readers, holds the same arena as the
    JAX engine reloading them, and finishes the expansion on the surface."""
    port = seeded_port(sc)
    jrec = JRec(sc.params, sc.images, JCfg(**KW), verbose=False)
    n = port.arena.count
    jrec.arena.append(**{k: v[:n] for k, v in port.arena.data.items()})
    jrec._update_neighbor_radius()
    jrec.autosave_interval = 40               # autosave mid-expansion
    ck = str(tmp_path / "auto_save.mvs")
    jrec.expand(max_rounds=3, autosave_path=ck)

    f = tmvs.read_mvs(ck)
    # the blob carries the reference's struct; the engine's batching knobs
    # come from config.txt, as in the CLI
    cfg = f.config.replace(batch_size=64, wavefront_size=64,
                           seed_refine_rounds=1)
    assert cfg == TCfg(**KW)
    rec = TRec(f.cameras, sc.images, cfg, verbose=False, device="cpu")
    assert rec.load_checkpoint(ck)
    jback = JRec(sc.params, sc.images, JCfg(**KW), verbose=False)
    assert jback.load_checkpoint(ck)
    assert_arenas_equal(rec.arena, jback.arena)
    assert rec.neighbor_radius == jback.neighbor_radius
    np.testing.assert_array_equal(rec.live_centers(), f.patches.centers)
    a = rec.arena
    frontier = int((~a.expanded[:a.count] & a.alive[:a.count]).sum())
    assert frontier > 0, "the autosave should hold a frontier"
    n0 = len(a.live_ids())
    rec.expand()
    assert len(a.live_ids()) > n0
    assert int((~a.expanded[:a.count] & a.alive[:a.count]).sum()) == 0
    assert np.median(sc.surface_distance(rec.live_centers())) < 0.01
