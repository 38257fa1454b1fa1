"""PyTorch port: the CLI's -r and -f modes end to end on the CPU
(``--device cpu``) on tests/test_cli.py's 4-camera synthetic scene: the
reference's artifacts, a mid-run autosave (and its live snapshot), the
``-r auto_save.mvs`` resume from it, ``-r`` from an ``.mvs`` without a
sidecar, bit-determinism for a fixed rngSeed, a clean SystemExit for
every mode outside the port, and no silent fallback to the CPU when the
GPU is missing."""

import json
import os
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


@pytest.mark.parametrize("argv,item", [
    (["-r", "scene.nvm", "-b"], 10),
    (["-v", "exp.mvs"], 10),
    (["-a", "exp.mvs"], 10),
    (["-r", "empty.nvm"], 10),
    (["-r", "scene.nvm", "--distributed-expansion"], 11),
    (["-r", "scene.nvm", "--distributed-expansion", "--mesh-shape", "4,x"],
     11),
    (["-r", "scene.nvm", "--mesh-shape", "2"], 11)])
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
