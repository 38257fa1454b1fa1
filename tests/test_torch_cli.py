"""PyTorch port: the CLI end to end on the CPU (``--device cpu``) on
tests/test_cli.py's 4-camera synthetic scene: -r and -f with the
reference's artifacts, a mid-run autosave (and its live snapshot), the
``-r auto_save.mvs`` resume from it, ``-r`` from an ``.mvs`` without a
sidecar, bit-determinism for a fixed rngSeed; ``-r`` on an NVM without
sparse points (feature seeding), ``-r -b`` (bundle adjustment), ``-v
--patch-id --reoptimize``, ``-a`` and ``--profile``; a clean SystemExit
for every flag outside the port, and no silent fallback to the CPU when
the GPU is missing."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu_torch import cli
from pais_mvs_tpu_torch.data.synthetic import make_scene
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
from pais_mvs_tpu_torch.io import mvsbin
from pais_mvs_tpu_torch.io.nvm import save_nvm
from pais_mvs_tpu_torch.io.pointcloud import read_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def test_profile_writes_a_trace(reconstructed, tmp_path):
    path, _ = reconstructed
    prof = tmp_path / "prof"
    assert cli.main(["-a", str(path), "-o", str(tmp_path), "--profile",
                     str(prof), "--device", "cpu"]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert (tmp_path / "animate.ply").exists()


@pytest.mark.parametrize("argv,item", [
    (["-r", "scene.nvm", "--distributed-expansion"], 11),
    (["-r", "scene.nvm", "--distributed-expansion", "--mesh-shape", "4,x"],
     11),
    (["-r", "scene.nvm", "--mesh-shape", "2"], 11),
    (["-r", "scene.nvm", "--coordinator", "localhost:1234"], 11),
    (["-r", "scene.nvm", "--num-processes", "2"], 11),
    (["-r", "scene.nvm", "--process-id", "0"], 11)])
def test_modes_outside_the_port_exit_cleanly(disk_scene, monkeypatch, argv,
                                             item):
    d, _ = disk_scene
    monkeypatch.chdir(d)
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    assert f"ROADMAP Queue 1 item {item}" in str(e.value.code)


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
