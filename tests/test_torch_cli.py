"""PyTorch port: the CLI end to end on the CPU (``--device cpu``) on
tests/test_cli.py's 4-camera synthetic scene: -r and -f with the
reference's artifacts, a mid-run autosave (and its live snapshot), the
``-r auto_save.mvs`` resume from it, ``-r`` from an ``.mvs`` without a
sidecar, bit-determinism for a fixed rngSeed; ``-r`` on an NVM without
sparse points (feature seeding), ``-r -b`` (bundle adjustment), ``-v
--patch-id --reoptimize``, ``-a`` and ``--profile`` (``-r`` with its
spans on the profiler's timeline and ``idle.json``); the job's spans and
counters in ``stats.json``, the sidecar deflate's among them; ``-r
--distributed-expansion`` in a world of one and in two processes joined by
``--coordinator`` (bit-equal clouds); a clean SystemExit for every
multi-process flag that cannot lay out the run, and no silent fallback to
the CPU when the GPU is missing."""

import json
import os
import shutil
import socket
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu_torch import cli
from pais_mvs_tpu_torch.data.synthetic import make_scene
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
from pais_mvs_tpu_torch.io import mvsbin, npz
from pais_mvs_tpu_torch.io.nvm import save_nvm
from pais_mvs_tpu_torch.io.pointcloud import read_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the spans and counters the benchmark's per-layer metrics read that every
# -r job records (the refine graphs' spans only on the card)
JOB_SPANS = ("job", "scene/decode", "scene/build", "seeds", "expand",
             "expand/prepare", "expand/insert", "autosave",
             "autosave/sidecar", "refine/enqueue", "refine/chunk",
             "refine/fetch", "writers")
GRAPH_SPANS = ("refine/draws", "refine/stage", "refine/replay",
               "refine/clone", "refine/first_run", "refine/capture",
               "refine/wait")
COUNTERS = ("rounds", "parents", "candidates", "refined_rows",
            "padded_rows", "scored_cams", "k1_tiled_rows",
            "k1_resampled_rows", "inserted",
            "autosaves", "autosave_bytes",
            "sidecar_raw_bytes", "deflate_blocks", "deflate_threads",
            "fetch_bytes", "graph_keys_captured", "graph_first_runs",
            "graph_replays")
OLD_KEYS = ("scene_build_s", "scene_undistort_s", "scene_upload_s",
            "scene_kernel_s", "scene_other_s", "refine_graphs",
            "refine_host_s", "seed_refine_s", "seed_rounds",
            "seed_accepted", "refine_graph_capture_s",
            "refine_graph_pool_bytes", "expansion_s", "expansion_device_s",
            "expansion_host_s", "expansion_refined", "expansion_pps",
            "expansion_refine_host_s", "live_patches")
CONFIG = ("patchRadius 4\nmaxLOD 3\nparticleNum 6\nmaxIteration 6\n"
          "distWeighting 1.3333\nseedRefineRounds 1\nminCamNum 3\n"
          "cellSize 14\nwavefrontSize 64\nbatchSize 64\n")


@pytest.fixture(scope="module")
def disk_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    from PIL import Image
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=12, seed=7)
    for p, img in zip(sc.params, sc.images):
        Image.fromarray(img).save(str(d / p.file_name))
    ipts = sc.seed_img_points.copy()
    ipts[..., 0] -= 80
    ipts[..., 1] -= 60
    save_nvm(str(d / "scene.nvm"), sc.params, sc.seed_centers,
             np.full((len(sc.seed_centers), 3), 128.0),
             sc.seed_cam_masks, ipts)
    save_nvm(str(d / "empty.nvm"), sc.params)
    (d / "config.txt").write_text(CONFIG)
    return d, sc


def test_reconstruct_filter_and_resume(disk_scene, monkeypatch, capsys):
    d, sc = disk_scene
    monkeypatch.chdir(d)          # config.txt + image paths resolve from cwd
    monkeypatch.setattr(Reconstructor, "autosave_interval", 40)
    assert cli.main(["-r", "scene.nvm", "-o", str(d), "--device", "cpu",
                     "--live-snapshots"]) == 0
    out = capsys.readouterr().out
    assert "\ntime1\t" in out
    for name in ("init.mvs", "seed.mvs", "exp.mvs", "exp.ply", "exp.psr",
                 "auto_save.mvs", "auto_save.mvs.state.npz", "stats.json",
                 "log.txt"):
        assert (d / name).exists(), name
    f = mvsbin.read_mvs(str(d / "exp.mvs"))
    assert len(f.patches.centers) > 80
    assert np.median(sc.surface_distance(f.patches.centers)) < 0.01
    stats = json.loads((d / "stats.json").read_text())
    assert stats["live_patches"] == len(f.patches.centers)
    assert 0 < stats["expansion_device_s"] <= stats["expansion_s"]
    check_job_trace(stats, d)
    assert len(read_ply(str(d / "exp.ply"))[0]) == len(f.patches.centers)
    assert os.path.getsize(d / "exp.psr") == 24 * len(f.patches.centers)
    saved = mvsbin.read_mvs(str(d / "auto_save.mvs"))
    assert 40 <= len(saved.patches.centers) < len(f.patches.centers)
    # --live-snapshots refreshes the cloud at every autosave
    snap = read_ply(str(d / "live_snapshot.ply"))[0]
    np.testing.assert_allclose(snap, saved.patches.centers, atol=1e-5)

    assert cli.main(["-f", "exp.mvs", "-o", str(d), "--device", "cpu"]) == 0
    for stem in ("PMVS_filter1", "PMVS_filter2", "PMVS_filter3",
                 "PMVS_filter_deleted", "PCMVS_filter",
                 "PCMVS_filter_deleted"):
        for ext in ("mvs", "ply"):
            assert (d / f"{stem}.{ext}").exists(), stem
    f3 = mvsbin.read_mvs(str(d / "PMVS_filter3.mvs"))
    gone = mvsbin.read_mvs(str(d / "PMVS_filter_deleted.mvs"))
    assert len(f3.patches.centers) + len(gone.patches.centers) == \
        len(f.patches.centers)
    assert "avg neighbours" in (d / "log.txt").read_text()

    res = d / "resumed"
    res.mkdir()
    capsys.readouterr()
    assert cli.main(["-r", str(d / "auto_save.mvs"), "-o", str(res),
                     "--device", "cpu"]) == 0
    assert "resumed checkpoint" in capsys.readouterr().out
    assert not (res / "seed.mvs").exists()      # no seed stage on resume
    r = mvsbin.read_mvs(str(res / "exp.mvs"))
    assert len(r.patches.centers) > len(saved.patches.centers)
    assert np.median(sc.surface_distance(r.patches.centers)) < 0.01

    # an .mvs without a sidecar: its patches are re-refined as seeds
    again = d / "from_seed_mvs"
    again.mkdir()
    assert cli.main(["-r", str(d / "seed.mvs"), "-o", str(again),
                     "--device", "cpu"]) == 0
    assert "resumed checkpoint" not in capsys.readouterr().out
    g = mvsbin.read_mvs(str(again / "exp.mvs"))
    assert len(g.patches.centers) > 80
    assert np.median(sc.surface_distance(g.patches.centers)) < 0.01


def check_job_trace(stats, d):
    """A -r job's ``stats.json``: its old keys, and the spans and
    counters of ``trace`` with the sums they must keep."""
    assert set(OLD_KEYS) <= set(stats)
    tr = stats["trace"]
    sp, c = tr["spans"], tr["counters"]
    assert set(JOB_SPANS) <= set(sp) and set(COUNTERS) == set(c)
    assert not set(GRAPH_SPANS) & set(sp)       # the CPU refines eagerly
    assert c["graph_keys_captured"] == c["graph_first_runs"] == 0
    # the root's self time and its children's totals make the job
    kids = ("scene/decode", "scene/build", "seeds/load", "seeds", "expand",
            "writers")
    assert sp["job"]["n"] == 1
    assert sp["job"]["self_s"] + sum(sp[k]["total_s"] for k in kids) == \
        pytest.approx(sp["job"]["total_s"], rel=1e-9)
    for v in sp.values():
        assert 0 <= v["self_s"] <= v["total_s"] + 1e-12
    # the stats the spans write
    assert stats["seed_refine_s"] == sp["seeds"]["total_s"]
    assert stats["expansion_s"] == sp["expand"]["total_s"]
    assert stats["refine_host_s"] == sp["refine/enqueue"]["total_s"]
    assert round(stats["scene_build_s"], 2) == round(
        sp["scene/build"]["total_s"], 2)
    assert 0 < c["inserted"] <= c["refined_rows"]
    assert c["inserted"] == stats["live_patches"]     # -r deletes none
    assert c["padded_rows"] < c["refined_rows"]
    assert c["rounds"] == sp["expand/prepare"]["n"] - 1   # the empty pop
    assert c["autosaves"] == sp["autosave"]["n"] >= 2
    assert c["autosave_bytes"] >= os.path.getsize(d / "auto_save.mvs") + \
        os.path.getsize(d / "auto_save.mvs.state.npz")
    check_sidecar_counters(c, d / "auto_save.mvs.state.npz")
    assert c["fetch_bytes"] > 0
    # the rounds table adds up to the expansion, less the grid build and
    # the loop's own steps
    rows = tr["rounds"]
    assert [r["round"] for r in rows] == list(range(len(rows)))
    cols = ("prepare_s", "enqueue_s", "fetch_s", "insert_s", "autosave_s")
    in_rounds = sum(r[k] for r in rows for k in cols)
    assert in_rounds <= stats["expansion_s"]
    assert in_rounds + sp["expand/grids"]["total_s"] == pytest.approx(
        stats["expansion_s"], rel=0.03)
    for k in ("parents", "candidates"):
        assert sum(r[k] for r in rows) == c[k]
    # the job's counters hold the seed stage's refines and inserts too
    assert sum(r["refined_rows"] for r in rows) < c["refined_rows"]
    assert sum(r["inserted"] for r in rows) == \
        c["inserted"] - stats["seed_accepted"]


def check_sidecar_counters(c, sidecar):
    """The sidecar deflate's counters: the ``.npy`` bytes deflated over
    the job's autosaves (the last sidecar's members among them), at least
    a block a member, and the deflate pool's width."""
    with zipfile.ZipFile(sidecar) as z:
        infos = z.infolist()
    assert sum(i.file_size for i in infos) <= c["sidecar_raw_bytes"]
    assert c["deflate_blocks"] >= len(infos) * c["autosaves"]
    assert c["deflate_blocks"] >= c["sidecar_raw_bytes"] / npz.BLOCK
    assert c["deflate_threads"] == npz.threads() >= 1


def test_stats_carry_the_sidecar_deflate(disk_scene, monkeypatch,
                                         tmp_path):
    """A -r job that autosaves counts the sidecar's raw bytes, the
    blocks it was deflated in and the deflate pool's width in
    ``stats.json``'s ``trace``; the sidecar is the zip ``np.load`` reads."""
    d, _ = disk_scene
    monkeypatch.chdir(d)
    monkeypatch.setattr(Reconstructor, "autosave_interval", 40)
    assert cli.main(["-r", "scene.nvm", "-o", str(tmp_path), "--device",
                     "cpu"]) == 0
    stats = json.loads((tmp_path / "stats.json").read_text())
    c = stats["trace"]["counters"]
    assert c["autosaves"] >= 2
    check_sidecar_counters(c, tmp_path / "auto_save.mvs.state.npz")
    with np.load(tmp_path / "auto_save.mvs.state.npz") as st:
        n = int(st["count"])
        assert 40 <= n < stats["live_patches"]
        assert st["d_img_point"].shape == (n, 4, 2)


def test_reconstruction_is_deterministic(disk_scene, monkeypatch, tmp_path):
    """Same rngSeed -> the same exp.mvs, byte for byte."""
    d, _ = disk_scene
    monkeypatch.chdir(d)
    outs = []
    for name in ("r1", "r2"):
        o = tmp_path / name
        o.mkdir()
        assert cli.main(["-r", "scene.nvm", "-o", str(o), "--device",
                         "cpu"]) == 0
        outs.append((o / "exp.mvs").read_bytes())
    assert outs[0] == outs[1]


@pytest.fixture(scope="module")
def reconstructed(disk_scene):
    """``-r scene.nvm``'s exp.mvs, beside the scene's images (the viewer
    loads them from the .mvs file's directory) as rec.mvs."""
    d, _ = disk_scene
    out = d / "rec"
    out.mkdir()
    here = os.getcwd()
    os.chdir(d)
    try:
        assert cli.main(["-r", "scene.nvm", "-o", str(out), "--device",
                         "cpu"]) == 0
    finally:
        os.chdir(here)
    shutil.copy(out / "exp.mvs", d / "rec.mvs")
    return d / "rec.mvs", mvsbin.read_mvs(str(d / "rec.mvs"))


def test_reconstruct_seeds_by_features(disk_scene, monkeypatch, tmp_path,
                                      capsys):
    """An NVM without sparse points: the seeds come from feature
    matching, and the cloud lies on the surface."""
    d, sc = disk_scene
    monkeypatch.chdir(d)
    assert cli.main(["-r", "empty.nvm", "-o", str(tmp_path), "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    n_seeds = int(out.split("feature seeding: ")[1].split()[0])
    assert n_seeds > 10
    f = mvsbin.read_mvs(str(tmp_path / "exp.mvs"))
    assert len(f.patches.centers) > 2 * n_seeds
    assert np.median(sc.surface_distance(f.patches.centers)) < 0.01
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["seed_accepted"] > 0.5 * n_seeds


def test_reconstruct_with_pose_refinement(disk_scene, reconstructed,
                                          monkeypatch, tmp_path, capsys):
    """-b bundle-adjusts the NVM's poses over its tracks, then
    reconstructs; without tracks (or from an .mvs) it warns and goes on."""
    d, sc = disk_scene
    monkeypatch.chdir(d)
    assert cli.main(["-r", "scene.nvm", "-b", "-o", str(tmp_path),
                     "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("pose refinement: reprojection RMS ")]
    assert len(line) == 1
    rms = [float(line[0].split()[i]) for i in (4, 6)]
    assert rms[1] <= rms[0] + 1e-3 and rms[1] < 0.01, line
    for name in ("init.mvs", "seed.mvs", "exp.mvs", "exp.ply", "exp.psr",
                 "stats.json", "log.txt"):
        assert (tmp_path / name).exists(), name
    f = mvsbin.read_mvs(str(tmp_path / "exp.mvs"))
    assert len(f.patches.centers) > 80
    assert np.median(sc.surface_distance(f.patches.centers)) < 0.01
    for src in ("empty.nvm", str(reconstructed[0])):
        o = tmp_path / os.path.basename(src).replace(".", "_")
        o.mkdir()
        assert cli.main(["-r", src, "-b", "-o", str(o), "--device",
                         "cpu"]) == 0
        assert "--refine-poses ignored" in (o / "log.txt").read_text()


def test_view_with_patch_diagnostics_and_reoptimize(disk_scene,
                                                    reconstructed,
                                                    monkeypatch, tmp_path,
                                                    capsys):
    d, _ = disk_scene
    path, f = reconstructed
    monkeypatch.chdir(d)
    assert cli.main(["-v", str(path), "--patch-id", "3", "--reoptimize",
                     "-o", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"patches: {len(f.patches.centers)}" in out
    assert "re-optimized: fitness" in out
    pts = read_ply(str(tmp_path / "view_snapshot.ply"))[0]
    np.testing.assert_allclose(pts, f.patches.centers, atol=1e-5)
    html = (tmp_path / "view.html").read_text()
    assert f"{len(f.patches.centers)} patches" in html
    # the picked patch before (id 3) and after re-optimization (3000001)
    for stem in ("patch3", "patch3000001"):
        for kind in ("views", "error"):
            assert (tmp_path / f"{stem}_{kind}.png").exists(), (stem, kind)
    with pytest.raises(SystemExit, match="out of range"):
        cli.main(["-v", str(path), "--patch-id", "100000", "-o",
                  str(tmp_path), "--device", "cpu"])


def test_animate_writes_insertion_order(reconstructed, tmp_path):
    path, f = reconstructed
    assert cli.main(["-a", str(path), "-o", str(tmp_path), "--device",
                     "cpu"]) == 0
    lines = (tmp_path / "animate.ply").read_text().splitlines()
    body = lines[lines.index("end_header") + 1:]
    n = len(f.patches.centers)
    assert len(body) == n
    order = np.array([float(ln.split()[-1]) for ln in body])
    np.testing.assert_allclose(order, np.arange(n) / (n - 1), atol=1e-6)
    xyz = np.array([[float(v) for v in ln.split()[:3]] for ln in body])
    np.testing.assert_allclose(xyz, f.patches.centers, atol=1e-5)


def test_profile_writes_a_trace(disk_scene, reconstructed, monkeypatch,
                                tmp_path):
    path, _ = reconstructed
    prof = tmp_path / "prof"
    assert cli.main(["-a", str(path), "-o", str(tmp_path), "--profile",
                     str(prof), "--device", "cpu"]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert (tmp_path / "animate.ply").exists()
    # -r: the job's spans on the profiler's timeline, and idle.json
    d, _ = disk_scene
    monkeypatch.chdir(d)
    monkeypatch.setattr(Reconstructor, "autosave_interval", 40)
    out = tmp_path / "r"
    assert cli.main(["-r", "scene.nvm", "-o", str(out), "--profile",
                     str(prof), "--device", "cpu"]) == 0
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = {e["name"].split(" round=")[0] for e in events
             if e.get("cat") == "user_annotation"}
    assert set(JOB_SPANS) | {"expand/round", "expand/candidates"} <= names
    assert any(e.get("name") == "expand/round round=0" for e in events)
    idle = json.loads((prof / "idle.json").read_text())
    assert idle["device"] == "cpu" and idle["job_s"] > 0
    assert idle["busy_s"] is None          # no device activity to attribute
    stats = json.loads((out / "stats.json").read_text())
    assert set(JOB_SPANS) <= set(stats["trace"]["spans"])


@pytest.mark.parametrize("argv,msg", [
    (["--distributed-expansion", "--mesh-shape", "4,x"],
     "--mesh-shape must be dp,vp"),
    (["--mesh-shape", "2"], "--mesh-shape must be dp,vp"),
    (["--distributed-expansion", "--mesh-shape", "1,3"],
     "view axis 3 must divide the camera count 4"),
    (["--distributed-expansion", "--mesh-shape", "2,1"],
     "needs 2 processes, the run has 1"),
    (["--num-processes", "2"], "--num-processes needs --coordinator"),
    (["--process-id", "0"], "--process-id needs --coordinator"),
    (["--coordinator", "localhost:1234", "--num-processes", "2",
      "--process-id", "2"], "--process-id 2 is outside [0, 2)"),
    (["--coordinator", "localhost", "--num-processes", "2",
      "--process-id", "0"], "--coordinator must be host:port")])
def test_bad_multi_process_flags_exit_cleanly(disk_scene, monkeypatch,
                                              tmp_path, argv, msg):
    """A flag that cannot lay out the run stops with a SystemExit naming
    it, before any refine (nothing is written)."""
    d, _ = disk_scene
    monkeypatch.chdir(d)
    with pytest.raises(SystemExit) as e:
        cli.main(["-r", "scene.nvm", "-o", str(tmp_path)] + argv
                 + ["--device", "cpu"])
    assert msg in str(e.value.code)
    assert not (tmp_path / "init.mvs").exists()


def test_distributed_expansion_in_a_world_of_one(disk_scene, monkeypatch,
                                                 tmp_path):
    d, sc = disk_scene
    monkeypatch.chdir(d)
    monkeypatch.setattr(Reconstructor, "autosave_interval", 40)
    assert cli.main(["-r", "scene.nvm", "--distributed-expansion", "-o",
                     str(tmp_path), "--device", "cpu"]) == 0
    for name in ("init.mvs", "seed.mvs", "exp.mvs", "auto_save.mvs",
                 "auto_save.mvs.state.npz", "exp.ply", "exp.psr",
                 "stats.json", "log.txt"):
        assert (tmp_path / name).exists(), name
    assert "dist round 0:" in (tmp_path / "log.txt").read_text()
    f = mvsbin.read_mvs(str(tmp_path / "exp.mvs"))
    assert len(f.patches.centers) > 80
    assert np.median(sc.surface_distance(f.patches.centers)) < 0.01
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["live_patches"] == len(f.patches.centers)
    assert stats["dist_refined"] > 0 and stats["dist_rounds"] > 1
    assert 0 < stats["dist_device_s"] <= stats["dist_expansion_s"] + 1e-3
    assert not torch.distributed.is_initialized()


def test_two_processes_write_equal_clouds(disk_scene, tmp_path):
    """Two CPU processes joined by --coordinator: the data-parallel seed
    refine (dataParallel on) and the distributed expansion; both write
    the same exp.mvs."""
    d, sc = disk_scene
    work = tmp_path / "scene"
    shutil.copytree(d, work, ignore=shutil.ignore_patterns(
        "*.mvs", "*.ply", "*.psr", "*.npz", "*.json", "log.txt", "r*",
        "from_*", "rec"))
    (work / "config.txt").write_text(CONFIG + "dataParallel on\n")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pais_mvs_tpu_torch.cli", "-r", "scene.nvm",
         "--distributed-expansion", "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(i), "-o",
         str(tmp_path / f"out{i}"), "--device", "cpu"],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:]
                                                     for o in outs]
    logs = [(tmp_path / f"out{i}" / "log.txt").read_text() for i in (0, 1)]
    assert all("data-parallel refine over 2 ranks" in t for t in logs)
    a, b = ((tmp_path / f"out{i}" / "exp.mvs").read_bytes() for i in (0, 1))
    assert a == b
    f = mvsbin.read_mvs(str(tmp_path / "out0" / "exp.mvs"))
    assert len(f.patches.centers) > 80
    assert np.median(sc.surface_distance(f.patches.centers)) < 0.01


def test_no_fallback_without_gpu(disk_scene):
    """Without --device the CLI asks for CUDA; with no GPU it fails rather
    than run on the CPU."""
    d, _ = disk_scene
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", "pais_mvs_tpu_torch.cli",
                        "-r", "scene.nvm", "-o", str(d / "nogpu")],
                       cwd=d, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "no GPU is available" in r.stderr
    assert not (d / "nogpu").exists()
