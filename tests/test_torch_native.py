"""PyTorch port: the native host runtime (``pais_mvs_tpu_torch/native``)
and the engine's bookkeeping around it against the JAX package, on the
same numpy inputs: tests/test_native.py's six parity cases (grid,
candidate generation, insert-time filter, post-filters, batch insert,
neighbour counts), each exact, the port's native runtime against the JAX
package's native runtime and its Python mirror. Also: the port's C++
source is the JAX package's byte for byte, and a failed build raises.
"""

import numpy as np
import pytest

from pais_mvs_tpu import native as jnative
from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.engine.arena import PatchArena as JArena
from pais_mvs_tpu.engine.cellgrid import CellGrids as JGrids
from pais_mvs_tpu.engine.reconstructor import Reconstructor as JRec
from pais_mvs_tpu_torch import native as tnative
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.engine.arena import PatchArena as TArena
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor as TRec
from test_torch_cellgrid import HEIGHTS, WIDTHS, cells_of, fake_arena

# (package name, Reconstructor, arena, Python grid, native module, config);
# the port has no Python grid
PKGS = {"jax": (JRec, JArena, JGrids, jnative, JCfg),
        "port": (TRec, TArena, None, tnative, TCfg)}
METHODS = ("_ensure_grids", "_delete", "_native_kill",
           "_generate_candidates", "cell_filtering",
           "visibility_filtering", "neighbor_cell_filtering",
           "neighbor_patch_filtering")
# the JAX engine's Python mirror of the runtime
JAX_MIRROR = ("_is_neighbor", "_skip_neighbor_cell",
              "_insert_time_cell_filter")


def engine_stub(pkg, native, arena, cfg_kw, neighbor_radius=0.15):
    """A Reconstructor without a scene: the package's own bookkeeping
    methods over ``arena`` and a grid built from it."""
    rec_cls, _, grids_cls, nat, cfg_cls = PKGS[pkg]

    class Stub:
        pass
    s = Stub()
    s.cfg = cfg_cls(**cfg_kw)
    s.arena = arena
    s.neighbor_radius = neighbor_radius
    cls = nat.NativeCellGrids if native else grids_cls
    s.grids = cls.build(arena, WIDTHS, HEIGHTS, s.cfg.cell_size)
    s.np_center = np.linspace(-1, 1, arena.num_cams * 3).reshape(-1, 3)
    s._log = lambda *args, **kw: None
    methods = METHODS
    if pkg == "jax":
        s.use_native = native
        methods += JAX_MIRROR
    for m in methods:
        setattr(s, m, getattr(rec_cls, m).__get__(s))
    return s


VARIANTS = [("jax", False), ("jax", True), ("port", True)]


def test_runtime_source_is_the_jax_packages():
    assert tnative.SRC.read_bytes() == \
        open(jnative._SRC, "rb").read()
    assert tnative.SRC.parent.name == "native"
    assert "pais_mvs_tpu_torch" in str(tnative.SRC)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.lib()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.NativeCellGrids(WIDTHS, HEIGHTS, 10)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TRec([], [], TCfg(), device="cpu")
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_candidate_generation_matches_jax():
    kw = dict(cell_size=10, max_cell_patch_num=3, min_correlation=0.8)
    outs = {}
    for pkg, nat in VARIANTS:
        a = fake_arena(PKGS[pkg][1], n=150)
        s = engine_stub(pkg, nat, a, kw)
        outs[pkg, nat] = s._generate_candidates(a.live_ids()[:40])
    want = outs["jax", False]
    assert len(want[0]) > 0
    for key, got in outs.items():
        for x, y in zip(got, want):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          str(key))
            assert np.asarray(x).dtype == np.asarray(y).dtype, key


def test_insert_time_filter_matches_jax():
    kw = dict(cell_size=10, max_cell_patch_num=2)
    verdicts = {}
    for pkg, nat in VARIANTS:
        a = fake_arena(PKGS[pkg][1], n=120)
        s = engine_stub(pkg, nat, a, kw)
        verdict = (s._insert_time_cell_filter if pkg == "jax" else
                   lambda cm, ip: s.grids.insert_time_filter(
                       cm, ip, s.cfg.max_cell_patch_num))
        verdicts[pkg, nat] = [
            verdict(a.data["cam_mask"][p], a.data["img_point"][p])
            for p in a.live_ids()[:60]]
    want = verdicts["jax", False]
    assert 0 < sum(want) < len(want)
    for key, got in verdicts.items():
        assert got == want, key


@pytest.mark.parametrize("fname,args", [
    ("cell_filtering", ()), ("visibility_filtering", ()),
    ("neighbor_cell_filtering", (0.25,)),
    ("neighbor_patch_filtering", (1.0,))])
def test_post_filters_match_jax(fname, args):
    """Kill for kill: the same removed count, alive set, deletion order
    and surviving grid, the port against JAX's native and Python paths."""
    kw = dict(cell_size=10, max_cell_patch_num=3, min_cam_num=2)
    res = {}
    for pkg, nat in VARIANTS:
        a = fake_arena(PKGS[pkg][1], n=300, seed=3)
        s = engine_stub(pkg, nat, a, kw)
        removed = getattr(s, fname)(*args)
        res[pkg, nat] = (removed, a.alive.copy(), list(a.deleted_ids),
                         cells_of(s.grids))
    want = res["jax", False]
    assert want[0] > 0, f"{fname}: degenerate test (nothing removed)"
    for key, got in res.items():
        assert got[0] == want[0], key
        np.testing.assert_array_equal(got[1], want[1], str(key))
        assert got[2] == want[2], key
        assert got[3] == want[3], key


def test_batch_insert_matches_jax():
    """tg_batch_insert through the port's binding accepts exactly what the
    JAX package's binding accepts, in the same order, and leaves the same
    grid."""
    rng = np.random.default_rng(11)
    C, N, nr = 4, 120, 0.3
    kw = dict(cell_size=10, max_cell_patch_num=2, min_correlation=0.8)
    keep = rng.uniform(size=N) < 0.8
    cam_masks = rng.uniform(size=(N, C)) < 0.7
    img_pts = rng.uniform(0, 150, (N, C, 2))
    order = rng.permutation(N).astype(np.int64)
    cand_cam = rng.integers(0, C, N).astype(np.int32)
    cand_cx = rng.integers(0, 14, N).astype(np.int32)
    cand_cy = rng.integers(0, 13, N).astype(np.int32)
    cand_center = rng.normal(size=(N, 3))
    cand_sph = np.stack([rng.uniform(0, np.pi, N),
                         rng.uniform(-np.pi, np.pi, N)], -1)
    cand_corr = rng.uniform(0.3, 1.0, N)
    res = {}
    for pkg in PKGS:
        a = fake_arena(PKGS[pkg][1], n=80, seed=5)
        s = engine_stub(pkg, True, a, kw, neighbor_radius=nr)
        parents = np.random.default_rng(12).choice(a.live_ids(), N)
        n = a.count
        accept = s.grids.batch_insert(
            order, keep, cam_masks, img_pts, parents.astype(np.int64),
            cand_cam, cand_cx, cand_cy, a.data["center"][:n],
            a.data["normal_sph"][:n], a.data["correlation"][:n],
            a.alive[:n].astype(np.uint8), cand_center, cand_sph, cand_corr,
            s.cfg.min_correlation, nr, s.cfg.max_cell_patch_num, n)
        res[pkg] = (accept, cells_of(s.grids))
    np.testing.assert_array_equal(res["port"][0], res["jax"][0])
    assert 0 < res["port"][0].sum() < keep.sum()
    assert res["port"][1] == res["jax"][1]


def test_neighbor_counts_match_bruteforce_and_jax():
    rng = np.random.default_rng(7)
    n = 500
    centers = rng.normal(size=(n, 3))
    ids = np.arange(n, dtype=np.int64)[::2]
    radius = 0.4
    got = tnative.neighbor_counts(centers, ids, radius)
    d = np.linalg.norm(centers[ids][:, None] - centers[ids][None, :],
                       axis=-1)
    want = (d <= radius).sum(axis=1) - 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jnative.neighbor_counts(centers, ids, radius))
