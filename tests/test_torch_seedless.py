"""PyTorch port on a rig with no sparse points (the DTU set's shape,
``benchmark/scenes/dtu_table.py``), on the CPU at a tiny size: the port's
feature seeding against the benchmark's plain float64 reference
(``benchmark/reference/features.py``), a bfloat16 reference apart; the
seeding's spans and counters and the four metrics that read them; the
renderer and the point-less NVM the CLI seeds from; the benchmark mode's
wrapper of the seeding, restored.

Bars, and why (the tiny rig: 5 cameras of 240x180 within +-20 degrees;
at 200x150 the texture's finest octave falls under two pixels and no
track survives):
  * keypoints: every port keypoint within KP_TOL = 0.01 px of one of the
    reference's, and as many (2.4e-4 px read: float32 against float64
    sub-pixel offsets);
  * descriptors of those keypoints within DESC_TOL = 1e-4 (1.6e-5 read);
  * pair matches: the same kept pairs, and each pair's matches the same
    keypoints (within KP_TOL);
  * seeds: ``seed_gap`` 0 and the same ``seed_px`` to 1e-3 px;
  * the bfloat16 reference (blur and descriptors): under half of its
    keypoints near the port's, and ``seed_gap`` above 0.5.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import scenes  # noqa: E402
from benchmark.metrics import (feature_detect_s, feature_match_s,  # noqa
                               feature_pair_ms, feature_tracks_s)
from benchmark.modes import r as bench_r  # noqa: E402
from benchmark.modes import r_seedless  # noqa: E402
from benchmark.reference import features as RF  # noqa: E402
from benchmark.scenes import dtu_table as DT  # noqa: E402
from pais_mvs_tpu_torch import cli, features  # noqa: E402
from pais_mvs_tpu_torch.config import MvsConfig  # noqa: E402
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor  # noqa
from pais_mvs_tpu_torch.features import seeding  # noqa: E402
from pais_mvs_tpu_torch.io import nvm as nvm_io  # noqa: E402
from pais_mvs_tpu_torch.models.camera import CameraParams  # noqa: E402
from pais_mvs_tpu_torch.trace import Trace  # noqa: E402

KP_TOL = 0.01
DESC_TOL = 1e-4
CFG = {"width": 240, "height": 180, "cameras": 5, "rows": 1,
       "azimuth": 20.0, "elevation": [30.0, 30.0],
       "focal": 2890.0 * 240 / 1600, "scene_seed": 5,
       "config_txt": {"patchRadius": 3, "maxLOD": 3, "particleNum": 4,
                      "maxIteration": 4, "seedRefineRounds": 1,
                      "minCamNum": 3}}


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """The tiny DTU-shaped scene, its files, the port's seeds (with a
    trace) and the reference's, float64 and bfloat16."""
    d = str(tmp_path_factory.mktemp("dtu"))
    sc = DT.render(CFG, 1)
    scenes.write_files(sc, CFG, d)
    grays = RF.load_gray(d, sc.cameras)
    cams = RF.cameras(sc.cameras)
    params = [CameraParams(file_name=c.name,
                           focal=np.array([c.focal] * 2),
                           principal=np.array([-1.0, -1.0]),
                           quaternion=np.asarray(c.quaternion),
                           center=np.asarray(c.center))
              for c in sc.cameras]
    images = [np.repeat(g.astype(np.uint8)[..., None], 3, -1)
              for g in grays]
    kps = [seeding.detect_and_describe(img, "cpu") for img in images]
    out = features.generate_seed_patches(
        params, images, MvsConfig(min_cam_num=3), device="cpu")
    ref = RF.seeds(grays, cams, 3, "cpu")
    low = RF.seeds(grays, cams, 3, "cpu", torch.bfloat16)
    return types.SimpleNamespace(
        dir=d, scene=sc, grays=grays, cams=cams, params=params,
        images=images, kps=kps, prog=RF.Seeds(*out[:3]), ref=ref, low=low)


@pytest.fixture(scope="module")
def cli_job(rig, tmp_path_factory):
    """The CLI's reconstructor built from the rig's point-less NVM, its
    seeding traced and kept by ``r_seedless``'s wrapper: (trace, the
    seeds, the log)."""
    out = tmp_path_factory.mktemp("out")
    ctx = types.SimpleNamespace(cfg={}, trace=False)
    ctx.patches = bench_r.Patches(ctx)
    r_seedless.keep_seeds(ctx)
    here = os.getcwd()
    os.chdir(rig.dir)
    tr = Trace()
    try:
        cli._build_reconstructor("scene.nvm", str(out), "cpu", trace=tr)
    finally:
        os.chdir(here)
        ctx.patches.restore()
    return types.SimpleNamespace(trace=tr, seeds=ctx.seeds,
                                 log=open(out / "log.txt").read())


def port_features(rig):
    """The port's keypoints and descriptors of each camera, masked."""
    return [(kp.xy.numpy()[kp.mask.numpy()].astype(float),
             d.numpy()[kp.mask.numpy()].astype(float)) for kp, d in rig.kps]


def nearest(a, b):
    """For each point of a [N, 2], its nearest of b [M, 2]: (index,
    distance)."""
    D = np.linalg.norm(a[:, None] - b[None], axis=-1)
    i = D.argmin(1)
    return i, D[np.arange(len(a)), i]


def test_keypoints_and_descriptors_match_reference(rig):
    port = port_features(rig)
    for dtype, agree in ((torch.float64, True), (torch.bfloat16, False)):
        blur = RF.Blur(dtype, "cpu")
        near = []
        for (pxy, pd), g in zip(port, rig.grays):
            rxy, rd = (t.numpy() for t in RF.features(g, blur, dtype,
                                                      "cpu"))
            i, dist = nearest(pxy, rxy)
            if agree:
                assert len(pxy) == len(rxy) and len(pxy) > 100
                assert dist.max() <= KP_TOL
                assert np.abs(pd - rd[i]).max() <= DESC_TOL
            near.append((dist <= KP_TOL).mean())
        if not agree:
            assert np.mean(near) < 0.5


def test_pair_matches_match_reference(rig):
    port = port_features(rig)
    xys = [torch.as_tensor(x) for x, _ in port]
    ref = RF.match(xys, [torch.as_tensor(d) for _, d in port], rig.cams,
                   "cpu")
    kps = [kp for kp, _ in rig.kps]
    descs = [d for _, d in rig.kps]
    Fs = [[None if i == j else seeding.mat.fundamental_from_rig(
        *pose(rig.params[i], rig.images[i]), *pose(rig.params[j],
                                                  rig.images[j]))
        for j in range(len(kps))] for i in range(len(kps))]
    got = seeding.mat.match_all_pairs(descs, [k.xy for k in kps],
                                      [k.mask for k in kps], Fs)
    assert set(got) == set(ref) and len(got) >= 5
    for p, (a, b) in got.items():
        i, j = p
        pa = kps[i].xy.numpy()[a].astype(float)
        pb = kps[j].xy.numpy()[b].astype(float)
        ra, rb = port[i][0][ref[p][0]], port[j][0][ref[p][1]]
        assert len(pa) == len(ra) > 0
        order = lambda x, y: np.lexsort((y[:, 1], y[:, 0], x[:, 1],
                                         x[:, 0]))
        o, q = order(pa, pb), order(ra, rb)
        assert np.abs(pa[o] - ra[q]).max() <= KP_TOL
        assert np.abs(pb[o] - rb[q]).max() <= KP_TOL


def pose(p, img):
    """(R, T, K) of a port camera as generate_seed_patches builds them."""
    from pais_mvs_tpu_torch.models.camera import _np_quat_to_rotation
    R = _np_quat_to_rotation(np.asarray(p.quaternion, float))
    h, w = img.shape[:2]
    f = np.asarray(p.focal, float)
    K = np.array([[f[0], 0, w >> 1], [0, f[1], h >> 1], [0, 0, 1.0]])
    return R, -R @ np.asarray(p.center, float), K


def test_seeds_match_reference_and_bfloat16_does_not(rig):
    assert len(rig.prog.masks) > 50
    assert RF.seed_gap(rig.prog, rig.ref) == 0.0
    px = RF.seed_px(rig.prog, rig.cams, rig.scene.surface)
    assert abs(px - RF.seed_px(rig.ref, rig.cams, rig.scene.surface)) < 1e-3
    assert np.isfinite(px) and px < 3.0
    assert RF.seed_gap(rig.low, rig.ref) > 0.5
    assert RF.seed_gap(rig.prog, rig.low) > 0.5


def test_spans_and_counters(rig, cli_job):
    s = cli_job.trace.summary()
    C = len(rig.params)
    assert s["spans"]["features/detect"]["n"] == C
    assert s["spans"]["features/match"]["n"] == 1
    assert s["spans"]["features/tracks"]["n"] == 1
    c = s["counters"]
    assert c["pairs_matched"] == C * (C - 1) // 2
    assert c["keypoints"] == sum(int(k.mask.sum()) for k, _ in rig.kps)
    assert c["feature_seeds"] == len(rig.prog.masks) == c["tracks"]
    assert 0 < c["pairs_kept"] <= c["pairs_matched"]
    assert c["pair_matches"] > 0


def test_traced_seeding_equals_untraced(rig, cli_job):
    """The CLI's traced seeding gives the seeds of an untraced call."""
    assert len(cli_job.seeds) == 1
    for a, b in zip(cli_job.seeds[0], rig.prog):
        assert np.array_equal(a, b)


def test_renderer_and_pointless_nvm(rig, monkeypatch):
    """No pixel is 0, the object stays whole in every frame (a rig whose
    frames cut it is refused), and the NVM holds no points: the CLI seeds
    from features."""
    assert all(img.min() > 0 for img in rig.scene.images)
    assert all((img[..., 0] == DT.BACKDROP).any()
               for img in rig.scene.images)
    monkeypatch.setattr(DT, "FILL", 1.1)
    with pytest.raises(AssertionError, match="leaves a frame"):
        DT.render(CFG, 1)
    monkeypatch.undo()
    data = nvm_io.load_nvm(os.path.join(rig.dir, "scene.nvm"))
    assert len(data.cameras) == CFG["cameras"] and len(data.centers) == 0


def test_cli_seeds_pointless_nvm(rig, cli_job):
    n = len(rig.prog.masks)
    assert f"feature seeding: {n} seeds" in cli_job.log
    assert {"seeds/load", "features/detect", "features/match",
            "features/tracks"} <= set(cli_job.trace.summary()["spans"])
    assert cli_job.trace.counters["feature_seeds"] == n


def run_with(stats_list):
    return types.SimpleNamespace(jobs=[{"stats": s} for s in stats_list])


def test_metrics_read_spans_and_none_without():
    trace = {"spans": {"features/detect": {"n": 5, "total_s": 1.5,
                                           "self_s": 1.5},
                       "features/match": {"n": 1, "total_s": 0.2,
                                          "self_s": 0.2},
                       "features/tracks": {"n": 1, "total_s": 0.05,
                                           "self_s": 0.05}},
             "counters": {"pairs_matched": 10}, "rounds": []}
    run = run_with([{"trace": trace}, {"trace": trace}])
    assert feature_detect_s.read(run) == 1.5
    assert feature_match_s.read(run) == 0.2
    assert feature_tracks_s.read(run) == 0.05
    assert feature_pair_ms.read(run) == pytest.approx(20.0)
    bare = run_with([{"trace": {"spans": {"seeds/load": {
        "n": 1, "total_s": 1.0, "self_s": 1.0}}, "counters": {},
        "rounds": []}}])
    for m in (feature_detect_s, feature_match_s, feature_tracks_s,
              feature_pair_ms):
        assert m.read(bare) is None
        assert m.read(run_with([{}])) is None


def test_seeds_wrapper_restores(monkeypatch):
    """``r_seedless`` keeps each call's seeds inside its profiler span and
    ``restore`` puts the program's seeding (and ``r``'s own wrappers)
    back."""
    made = (np.ones((2, 3)), np.ones((2, 4), bool), np.ones((2, 4, 2)),
            np.zeros((2, 3)))
    monkeypatch.setattr(features, "generate_seed_patches",
                        lambda *a, **k: made)
    orig, expand = features.generate_seed_patches, Reconstructor.expand
    ctx = types.SimpleNamespace(cfg={}, trace=False)
    ctx.patches = bench_r.Patches(ctx)
    r_seedless.keep_seeds(ctx)
    try:
        assert features.generate_seed_patches is not orig
        assert Reconstructor.expand is not expand
        assert features.generate_seed_patches("cams", "images") is made
        assert len(ctx.seeds) == 1
        assert all(np.array_equal(a, b) for a, b in zip(ctx.seeds[0],
                                                         made[:3]))
    finally:
        ctx.patches.restore()
    assert features.generate_seed_patches is orig
    assert Reconstructor.expand is expand
    ctx.patches.restore()
    assert features.generate_seed_patches is orig


def test_cell_files():
    """The cell's files: its configuration keeps the source's widths, the
    traffic names this mode, the limits cover the seeds' readings."""
    bench = os.path.join(ROOT, "benchmark")
    load = lambda kind, name: json.load(open(os.path.join(
        bench, kind, f"{name}.json")))
    cell = load("workloads", "dtu-r")
    cfg = load("configs", cell["config"])
    assert (cfg["cameras"], cfg["width"], cfg["height"], cfg["focal"]) == (
        49, 1600, 1200, 2890)
    assert cfg["reduced"] == ["expansion_round_cap"]
    assert load("traffic", cell["traffic"])["mode"] == "r_seedless"
    assert {"seed_gap", "seed_px", "fit_gap", "depth_px"} <= set(
        cell["limits"])
