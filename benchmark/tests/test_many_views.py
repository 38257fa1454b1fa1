"""The many-view cell's files (``modes/r_many_views.py``,
``reference/check_many_views.py``, ``scenes/hemisphere_object.py``) on
the CPU at a tiny size (``tests/data``: 40 hemisphere views at 96x72,
r=3, PSO 6x6, one round): the comparison's scores are the reference's,
a sound run is correct, the control is not, and the three planted faults
of ``test_bench_run`` each fail it. On the
card (``gpu`` marker) the faults fail ``temple-r`` at its own size and
limits.

    python -m pytest benchmark/tests/test_many_views.py -q
    python -m pytest benchmark/tests/test_many_views.py -q -m gpu
"""

import argparse
import contextlib
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark import scenes
from benchmark.reference import check_many_views as CM
from benchmark.reference.photo import RefScene, engine_params
from benchmark.scenes import hemisphere_object as HO
from benchmark.tests.test_bench_run import DATA, FAULTS, card, planted

__all__ = ["card"]


def test_scores_are_the_references():
    """The many-view comparison's scores of states, computed once per
    (patch, reference camera, level): the fitness bit-equal to
    ``RefScene.fitness`` and the correlation to 1e-12 of
    ``RefScene.correlation``, on sets of 40 hemisphere views."""
    cfg = json.load(open(os.path.join(DATA, "configs",
                                      "temple-tiny.json")))
    sc = HO.render(cfg, 1)
    with tempfile.TemporaryDirectory() as d:
        scenes.write_files(sc, cfg, d)
        ref = RefScene(d, sc.cameras, engine_params(cfg["config_txt"]))
    N, C = sc.seed_masks.shape
    rng = np.random.default_rng(0)
    pi = torch.as_tensor(np.repeat(np.arange(N), 3))
    m = torch.as_tensor(sc.seed_masks)[pi]
    mk = m & torch.as_tensor(rng.random((len(pi), C)) > 0.2)
    rc = torch.argmax(mk.int(), 1)
    c = torch.as_tensor(sc.seed_points)[pi]
    n = HO.normal_at(c)
    lod = ref.lod(c, rc)
    f, q = CM.scores(ref, pi, c, n, rc, mk, lod, rows=7)
    f0 = ref.fitness(c[:, None], n, rc, mk, lod)[:, 0]
    q0 = ref.correlation(c, n, rc, mk, lod)[0]
    assert (f0 < 1e29).sum() > 10
    assert torch.equal(f, f0)
    assert float((q - q0).abs().max()) < 1e-12


def tiny(control=0, seed=2 ** 31 + 11):
    """One run of the tiny hemisphere cell on the CPU: (exit code, last
    line)."""
    args = argparse.Namespace(workload="temple-tiny", seed=seed,
                              seconds=0.1, trace=0, control=control)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.run_cell(args, device=torch.device("cpu"),
                                bench=DATA)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_sound_run_is_correct():
    rc, line = tiny()
    assert rc == 0
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"fit_gap", "fit_gap_max", "corr_gap",
                                   "depth_px"}
    r = line["readings"]
    # the bounded states: a few hundred a patch at most
    assert 0 < r["states"] <= 400 * r["patches"]


def test_control_fails():
    """The reference one precision step down, judged in the program's
    place over the same bounded states, comes out not correct."""
    rc, line = tiny(control=1)
    assert rc == 0
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["fit_gap"]["value"] > 10 * checks["fit_gap"]["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_fail(fault):
    with planted(fault):
        rc, line = tiny()
    assert rc != 0 or not line["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS)
def test_faults_fail_on_card(card, fault):
    """Each fault planted in a short run of ``temple-r``, at the cell's
    own size and limits, turns ``correct`` false (or fails the run)."""
    args = argparse.Namespace(workload="temple-r", seed=2 ** 31 + 5,
                              seconds=1, trace=0, control=0)
    out = io.StringIO()
    with planted(fault), contextlib.redirect_stdout(out):
        rc = bench_run.run_cell(args)
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if lines else None
    print("temple-r", fault, "rc", rc, json.dumps(line and line["checks"]))
    assert rc != 0 or not line["correct"]
