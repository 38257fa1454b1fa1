"""The harness on the CPU at a tiny size (``tests/data``: the pawn rig at
160x120, r=4, PSO 6x6, three rounds): the result line, the comparison,
its control, the faults it has to catch, and files dropped in by name.
On the card (``gpu`` marker) a cell runs as the driver runs it.

    python -m pytest benchmark/tests -q              # CPU
    python -m pytest benchmark/tests -q -m gpu       # on the card
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run as bench_run

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")
EXTRA = ("breakdown", "k1", "readings", "checks")


def tiny(bench=DATA, control=0, seed=2 ** 31 + 11, bench_json=None):
    """One run of the tiny cell on the CPU: (exit code, last line)."""
    args = argparse.Namespace(workload="pawn-tiny", seed=seed, seconds=0.1,
                              trace=0, control=control)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.run_cell(args, device=torch.device("cpu"),
                                bench=bench, bench_json=bench_json)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture(scope="module")
def sound():
    return tiny()


@pytest.fixture(scope="module")
def control():
    return tiny(control=1)


def test_result_line(sound):
    rc, line = sound
    assert rc == 0
    assert all(k in line for k in REQUIRED)
    assert set(line) <= set(REQUIRED + EXTRA)
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0


def test_sound_run_is_correct(sound):
    rc, line = sound
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"fit_gap", "fit_gap_max", "corr_gap",
                                   "depth_px"}
    assert "control" not in line["readings"]


def test_control_fails(control):
    """The reference in bfloat16 arithmetic over float8 atlases, judged
    in the program's place by the run's own comparison, comes out not
    correct."""
    rc, line = control
    assert rc == 0
    assert line["correct"] is False
    checks = line["checks"]
    assert any(c["value"] > c["limit"] for c in checks.values())
    assert checks["fit_gap"]["value"] > 10 * checks["fit_gap"]["limit"]
    assert checks["fit_gap"]["value"] == line["readings"]["control"][
        "fit_gap"]


def test_no_forbidden_modules_after_a_run(sound):
    assert bench_run.forbidden_modules() == []


@contextlib.contextmanager
def patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def unchanged_refine(orig):
    """A refine that returns its state unchanged."""
    def call(scene, cfg, pb, *a, **k):
        from pais_mvs_tpu_torch.ops.lifecycle import RefineResult
        return RefineResult(pb, torch.zeros(pb.capacity, dtype=torch.int32,
                                            device=pb.center.device))
    return call


def altered_fitness(orig):
    """K1's answers, each altered by 1% where they are produced."""
    def call(*a, **k):
        return orig(*a, **k) * 1.01
    return call


def moved_cloud(orig):
    """The writer moves every patch a hundredth of its distance from the
    origin outwards."""
    def call(rec, path, deleted=False):
        data = rec.patch_data(deleted)
        from pais_mvs_tpu_torch.io.mvsbin import write_mvs
        moved = data._replace(centers=data.centers * 1.01)
        write_mvs(path, rec.cfg, rec.params, moved)
    return call


FAULTS = ("unchanged_refine", "altered_fitness", "moved_cloud")


def planted(fault):
    """The fault ``fault`` planted in the program for a ``with`` block."""
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    from pais_mvs_tpu_torch.ops import cuda_fitness, lifecycle
    where = {"unchanged_refine": (lifecycle, "refine_batch"),
             "altered_fitness": (cuda_fitness, "score_windows"),
             "moved_cloud": (Reconstructor, "write_mvs")}[fault]
    return patched(*where, globals()[fault])


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_fail(fault):
    with planted(fault):
        rc, line = tiny()
    assert rc != 0 or not line["correct"]


def test_unknown_traffic_key_is_refused(tmp_path):
    """A traffic file asking for what its mode does not implement (here
    four clients) is refused, not measured as one client."""
    for kind in ("configs", "workloads", "traffic"):
        shutil.copytree(os.path.join(DATA, kind), tmp_path / kind)
    path = tmp_path / "traffic" / "r-jobs.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    clients=4)))
    rc, line = tiny(bench=str(tmp_path))
    assert rc != 0 and line is None


def test_files_found_by_name(tmp_path):
    """A configuration, a cell, a traffic mix and a metric dropped in as
    files are found with no edit of the harness."""
    for kind in ("configs", "workloads", "traffic"):
        shutil.copytree(os.path.join(DATA, kind), tmp_path / kind)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "dummy_metric.py").write_text(
        "def read(run):\n    return 42.0 + len(run.jobs) * 0\n")
    spec = {"end_to_end": [{"name": "dummy_metric", "unit": "s",
                            "better": "lower", "bound": 0.1,
                            "source": "host_clock"},
                           {"name": "job_s", "unit": "s", "better": "lower",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": ["elsewhere"]}],
            "per_layer": []}
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    rc, line = tiny(bench=str(tmp_path), bench_json=str(path))
    assert rc == 0
    assert line["metrics"] == {"dummy_metric": {"value": 42.0, "unit": "s"}}


def fresh_modules(code: str) -> set:
    """Top-level names of the modules loaded by ``code`` in a fresh
    interpreter."""
    src = code + ("\nimport sys, json\nprint(json.dumps(sorted("
                  "{m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", src], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    mods = fresh_modules("import benchmark.run, benchmark.modes.r, "
                         "benchmark.trace, benchmark.roofline")
    assert not mods & {"jax", "jaxlib", "flax", "pais_mvs_tpu"}


def test_reference_imports_no_program():
    mods = fresh_modules("import benchmark.reference.check, "
                         "benchmark.reference.photo, "
                         "benchmark.reference.mvsfile, benchmark.scenes."
                         "pawn_step, benchmark.scenes.curved_facade")
    assert not mods & {"jax", "jaxlib", "flax", "pais_mvs_tpu",
                       "pais_mvs_tpu_torch"}


def test_measured_path_raises_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "pawn-r",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_scenes_fixed_by_configuration():
    """Every run seed renders the same scene (the configuration's
    scene_seed fixes it); the run seed draws the patches judged."""
    from benchmark import scenes
    from benchmark.modes.r import samples
    from benchmark.reference.mvsfile import Cloud
    cfg = json.load(open(os.path.join(DATA, "configs", "pawn-tiny.json")))
    a = scenes.render("pawn_step", cfg, 1)
    b = scenes.render("pawn_step", cfg, 2 ** 31 + 7)
    assert all(np.array_equal(x, y) for x, y in zip(a.images, b.images))
    assert np.array_equal(a.seed_points, b.seed_points)
    c = scenes.render("pawn_step", dict(cfg, scene_seed=1), 1)
    assert not np.array_equal(a.seed_points, c.seed_points)
    fac = {"width": 96, "height": 64, "cameras": 4, "seeds": 30,
           "amplitude": 0.06, "scene_seed": 7}
    f1 = scenes.render("curved_facade", fac, 1)
    f2 = scenes.render("curved_facade", fac, 5)
    assert all(np.array_equal(x, y) for x, y in zip(f1.images, f2.images))
    assert len(f1.seed_points) > 0

    cloud = Cloud(np.random.rand(500, 3), np.random.rand(500, 2),
                  np.ones((500, 5), bool), np.random.rand(500),
                  np.random.rand(500))
    picks = [samples(seed, [cloud], 16).centers for seed in (1, 2, 1)]
    assert np.array_equal(picks[0], picks[2])
    assert not np.array_equal(picks[0], picks[1])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def card_run(cell, seed, control=0):
    """One short run of ``cell`` on the card as the driver starts it:
    (exit code, last line, standard error)."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(seed), "--seconds", "1", "--trace", "0",
         "--control", str(control)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    return out.returncode, (json.loads(lines[-1]) if lines else None), \
        out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["pawn-r", "herzjesu-r"])
def test_cell_on_card_with_control(card, cell):
    """A short run of each cell on the card is correct, and the same run
    with the control in the program's place is not."""
    rc, line, err = card_run(cell, 2 ** 31 + 77)
    assert rc == 0, err[-2000:]
    assert line["correct"], line["checks"]
    rc, line, err = card_run(cell, 2 ** 31 + 77, control=1)
    assert rc == 0, err[-2000:]
    print(cell, "control", json.dumps(line["checks"]))
    assert line["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["pawn-r", "herzjesu-r"])
def test_faults_fail_on_card(card, cell, fault):
    """Each fault planted in a short run of a real cell, at the cell's own
    size and limits, turns ``correct`` false (or fails the run)."""
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 5, seconds=1,
                              trace=0, control=0)
    out = io.StringIO()
    with planted(fault), contextlib.redirect_stdout(out):
        rc = bench_run.run_cell(args)
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if lines else None
    print(cell, fault, "rc", rc, json.dumps(line and line["checks"]))
    assert rc != 0 or not line["correct"]
