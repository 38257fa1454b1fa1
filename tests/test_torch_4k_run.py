"""PyTorch port: ``pais_mvs_tpu_torch/tools/gpu_4k_run.py``, the
counterpart of the JAX package's ``tools/tpu_4k_run.py``, on the CPU at
8 cameras x 256x192 and 40 seeds.

``write_scene`` writes the same files as the JAX tool's scene code
(tools/tpu_4k_run.py:49-65, reproduced here with the JAX package's
``make_scene`` and ``save_nvm``, since it sits inline in the tool's
``main``); the port's curved scene equals the JAX package's bit for bit;
``run`` returns every field, stops the expansion at its round cap, times
the autosaves and restores what it wraps even when the CLI raises. The
tool's config.txt (r=15, PSO 15 x 30, B=1024) takes half an hour on this
CPU through the plain twins, so ``run`` is driven here with a lighter one
over the same PNGs and NVM.
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu_torch import cli
from pais_mvs_tpu_torch.data import synthetic as port_synth
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
from pais_mvs_tpu_torch.io import mvsbin
from pais_mvs_tpu_torch.tools import gpu_4k_run as G

CAMS, W, H, SEEDS = 8, 256, 192, 40
# the same PNGs and NVM under a config the CPU runs in seconds
LIGHT_CONFIG = ("patchRadius 3\nmaxLOD 3\nparticleNum 4\nmaxIteration 4\n"
                "distWeighting 1.0\ncellSize 8\nminCamNum 3\n"
                "seedRefineRounds 1\nbatchSize 64\nwavefrontSize 64\n")
# tools/tpu_4k_run.py's fields, and the port's additions
JAX_FIELDS = ("scene", "pipeline_expansion", "rounds_cap", "patches",
              "median_surface_dist", "p95_surface_dist", "wall_s",
              "expansion_s", "expansion_device_s", "expansion_host_s",
              "expansion_refined", "expansion_pps")
PORT_FIELDS = ("scene_build_s", "seed_s", "scene_device_bytes",
               "peak_device_GiB", "refine_graphs", "card", "autosaves",
               "autosave_s", "expansion_rounds", "writers_s", "decode_s",
               *G.SPLIT)


def jax_tool_scene(out_dir, pipeline=0):
    """tools/tpu_4k_run.py:49-65 at this test's size: the image points
    decentred by half the image, as (2048, 1536) is at 4096x3072."""
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.io.nvm import save_nvm
    sc = make_scene(num_cams=CAMS, width=W, height=H, num_seeds=SEEDS,
                    seed=7, amplitude=0.06)
    for p, img in zip(sc.params, sc.images):
        Image.fromarray(img).save(os.path.join(out_dir, p.file_name))
    save_nvm(os.path.join(out_dir, "scene.nvm"), sc.params, sc.seed_centers,
             np.full((len(sc.seed_centers), 3), 128.0),
             sc.seed_cam_masks, sc.seed_img_points
             - np.array([[[W / 2, H / 2]]]))
    with open(os.path.join(out_dir, "config.txt"), "w") as f:
        f.write("patchRadius 15\nmaxLOD 8\nparticleNum 15\n"
                "maxIteration 30\ndistWeighting 5.0\ncellSize 16\n"
                "minCamNum 3\nseedRefineRounds 2\nbatchSize 1024\n"
                "wavefrontSize 4096\n"
                f"pipelineExpansion {pipeline}\n")
    return sc


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    port_dir = tmp_path_factory.mktemp("port")
    jax_dir = tmp_path_factory.mktemp("jax")
    sc = G.write_scene(str(port_dir), seeds=SEEDS, num_cams=CAMS, width=W,
                       height=H)
    jax_tool_scene(str(jax_dir))
    return port_dir, jax_dir, sc


def test_write_scene_matches_jax_tool(written):
    port_dir, jax_dir, sc = written
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    pngs = [n for n in names if n.endswith(".png")]
    assert len(pngs) == CAMS
    for n in pngs:
        a = np.asarray(Image.open(port_dir / n))
        b = np.asarray(Image.open(jax_dir / n))
        assert a.shape == (H, W, 3) and np.array_equal(a, b), n
    for n in ("scene.nvm", "config.txt"):
        assert (port_dir / n).read_text() == (jax_dir / n).read_text(), n
    assert len(sc.seed_centers) == SEEDS


@pytest.mark.parametrize("pipeline", [0, 1])
def test_config_txt_is_the_jax_tools(tmp_path, pipeline):
    jax_tool_scene(str(tmp_path), pipeline)
    assert (tmp_path / "config.txt").read_text() == G.config_txt(pipeline)


@pytest.mark.parametrize("amplitude", [0.05, 0.06])
def test_curved_scene_bit_equal_to_jax(amplitude):
    from pais_mvs_tpu.data import synthetic as jax_synth
    kw = dict(num_cams=CAMS, width=W, height=H, num_seeds=SEEDS, seed=7,
              amplitude=amplitude)
    a, b = port_synth.make_scene(**kw), jax_synth.make_scene(**kw)
    assert len(a.images) == len(b.images) == CAMS
    for x, y in zip(a.images, b.images):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for f in ("seed_centers", "seed_cam_masks", "seed_img_points",
              "seed_colors", "plane_normal", "plane_point"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for p, q in zip(a.params, b.params):
        assert p.file_name == q.file_name
        for f in ("focal", "principal", "quaternion", "center"):
            assert np.array_equal(getattr(p, f), getattr(q, f)), f
    pts = np.random.default_rng(3).uniform(-0.8, 0.8, (500, 3)) \
        * np.array([1.0, 0.75, 0.1])
    da, db = a.surface_distance(pts), b.surface_distance(pts)
    assert np.abs(da).max() > 0
    np.testing.assert_allclose(da, db, rtol=0, atol=1e-12)


def light_copy(src, dst):
    shutil.copytree(src, dst)
    (dst / "config.txt").write_text(LIGHT_CONFIG)
    return dst


def test_run_caps_rounds_and_reports(written, tmp_path, monkeypatch):
    port_dir, _, sc = written
    d = light_copy(port_dir, tmp_path / "run")
    monkeypatch.setattr(Reconstructor, "autosave_interval", 40)
    here = os.getcwd()
    keep = []
    out = G.run(str(d), sc, rounds=2, device="cpu", keep=keep)
    assert os.getcwd() == here
    for k in JAX_FIELDS + PORT_FIELDS:
        assert k in out, k
    assert out["rounds_cap"] == 2 and out["expansion_rounds"] == 2
    log = (d / "log.txt").read_text()
    assert "round 1:" in log and "round 2:" not in log
    f = mvsbin.read_mvs(str(d / "exp.mvs"))
    assert out["patches"] == len(f.patches.centers) > out["seed_accepted"]
    assert out["median_surface_dist"] == float(
        np.median(sc.surface_distance(f.patches.centers)))
    assert out["median_surface_dist"] < 0.01
    assert out["autosaves"] >= 1 and out["autosave_s"] > 0
    assert out["device"] == "cpu" and out["card"] is None
    assert out["peak_device_GiB"] is None
    assert out["refine_graphs"]["captured"] == 0
    assert out["scene_device_bytes"] == G.scene_bytes(keep[0].scene) > 0
    assert 0 < out["scene_build_s"] < out["wall_s"]
    assert all(out[k] >= 0 for k in G.SPLIT)
    assert out["scene_kernel_s"] > 0
    assert out["expansion_refined"] > 0
    # one more round than the cap on the same files grows the cloud:
    # the cap, not the frontier, ended the run
    more = G.run(str(light_copy(port_dir, tmp_path / "more")), sc,
                 rounds=3, device="cpu")
    assert more["expansion_rounds"] == 3
    assert more["patches"] > out["patches"]


def test_run_restores_wrapped_methods_when_cli_raises(written, tmp_path,
                                                       monkeypatch):
    port_dir, _, sc = written
    d = light_copy(port_dir, tmp_path / "raises")
    wrapped = (Reconstructor.expand, Reconstructor.save_checkpoint,
               cli._build_reconstructor)

    def boom(self):
        raise RuntimeError("seed refinement failed")

    monkeypatch.setattr(Reconstructor, "refine_seeds", boom)
    here = os.getcwd()
    with pytest.raises(RuntimeError, match="seed refinement failed"):
        G.run(str(d), sc, rounds=2, device="cpu")
    assert (Reconstructor.expand, Reconstructor.save_checkpoint,
            cli._build_reconstructor) == wrapped
    assert os.getcwd() == here


def test_cloud_agrees_with_jax_cli(written, tmp_path, monkeypatch):
    """The port's capped run against the JAX CLI's, capped the way
    tools/tpu_4k_run.py caps it, on the same files: mutual agreement at
    half a cell >= 0.65 each way and a count ratio in [0.7, 1.43] (the
    distributed parity tests' bars; the two draw different PSO streams)."""
    from scipy.spatial import cKDTree
    import pais_mvs_tpu.engine.reconstructor as jax_recon
    from pais_mvs_tpu import cli as jax_cli
    port_dir, _, sc = written
    rounds = 3
    out = G.run(str(light_copy(port_dir, tmp_path / "port")), sc,
                rounds=rounds, device="cpu")
    d = light_copy(port_dir, tmp_path / "jax")
    orig = jax_recon.Reconstructor.expand
    monkeypatch.setattr(
        jax_recon.Reconstructor, "expand",
        lambda self, max_rounds=10_000, autosave_path=None:
            orig(self, max_rounds=rounds, autosave_path=autosave_path))
    monkeypatch.chdir(d)
    assert jax_cli.main(["-r", "scene.nvm", "-o", str(d)]) == 0
    a = mvsbin.read_mvs(str(tmp_path / "port" / "exp.mvs")).patches.centers
    b = mvsbin.read_mvs(str(d / "exp.mvs")).patches.centers
    cams = np.array([p.center for p in sc.params])
    depth = float(np.linalg.norm(sc.seed_centers.mean(0) - cams.mean(0)))
    tol = 0.5 * 8 * depth / float(sc.params[0].focal[0])
    ag = ((cKDTree(b).query(a)[0] <= tol).mean(),
          (cKDTree(a).query(b)[0] <= tol).mean())
    assert len(a) == out["patches"]
    assert min(ag) >= 0.65, ag
    assert 0.7 <= len(a) / len(b) <= 1.43, (len(a), len(b))
