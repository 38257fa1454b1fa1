"""The seedless cell's files (``modes/r_seedless.py``,
``reference/features.py``, ``scenes/dtu_table.py``) on the CPU at a tiny
size (``tests/data``: 5 views of the table-top object at 240x180 within
+-20 degrees, r=3, PSO 6x6, one round): a sound run is correct and judges
its seeds, the control is not, and each planted fault fails it: the
seeding's own two (keypoints moved a pixel before description, Lowe's
ratio test dropped) and ``test_bench_run``'s writer fault. On the card
(``gpu`` marker) these and K1's fault fail ``dtu-r`` at its own size and
limits. K1's 1% is judged on the card only: at this size the table's
patches, seen at 30 degrees by every camera, read fitness gaps of 1-2%
(the 90th percentile 0.013-0.017; 3.8e-5 at ``dtu-r``'s size), so the
tiny cell's ``fit_gap`` limit is 0.05.

    python -m pytest benchmark/tests/test_seedless.py -q
    python -m pytest benchmark/tests/test_seedless.py -q -m gpu -s
"""

import argparse
import contextlib
import io
import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.test_bench_run import DATA, card, patched, planted

__all__ = ["card"]


def shifted_keypoints(orig):
    """Every keypoint moved one pixel along x before its description."""
    def call(*a, **k):
        kp, gaussians = orig(*a, **k)
        one = torch.tensor([1.0, 0.0], device=kp.xy.device)
        scale = (2.0 ** kp.octave.to(kp.xy.dtype))[:, None]
        return kp._replace(xy=kp.xy + one,
                           xy_oct=kp.xy_oct + one / scale), gaussians
    return call


def no_ratio_test(orig):
    """Matching without Lowe's ratio test."""
    def call(*a, **k):
        return orig(*a, **dict(k, ratio=float("inf")))
    return call


SEED_FAULTS = ("shifted_keypoints", "no_ratio_test")
TINY_FAULTS = SEED_FAULTS + ("moved_cloud",)
FAULTS = TINY_FAULTS + ("altered_fitness",)


def plant(fault):
    from pais_mvs_tpu_torch.features import detect, matching
    if fault == "shifted_keypoints":
        return patched(detect, "detect_keypoints", shifted_keypoints)
    if fault == "no_ratio_test":
        return patched(matching, "match_all_pairs", no_ratio_test)
    return planted(fault)


def run(workload, control=0, seed=2 ** 31 + 11, seconds=0.1, device=None,
        bench=DATA):
    args = argparse.Namespace(workload=workload, seed=seed,
                              seconds=seconds, trace=0, control=control)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.run_cell(args, device=device, bench=bench)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def tiny(control=0):
    return run("dtu-tiny", control, device=torch.device("cpu"))


def test_sound_run_is_correct():
    rc, line = tiny()
    assert rc == 0
    assert line["correct"], line["checks"]
    assert {"seed_gap", "seed_px"} <= set(line["checks"])
    seeds = line["readings"]["seeds"]
    assert seeds["program"] == [seeds["reference"]] and seeds["reference"]
    assert line["checks"]["seed_gap"]["value"] == 0.0


def test_control_fails():
    rc, line = tiny(control=1)
    assert rc == 0
    assert line["correct"] is False
    c = line["checks"]
    assert c["seed_gap"]["value"] > 10 * c["seed_gap"]["limit"]


@pytest.mark.parametrize("fault", TINY_FAULTS)
def test_faults_fail(fault):
    with plant(fault):
        rc, line = tiny()
    assert rc != 0 or not line["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS)
def test_faults_fail_on_card(card, fault):
    """Each fault planted in a short run of ``dtu-r``, at the cell's own
    size and limits, turns ``correct`` false (or fails the run)."""
    from benchmark.run import BENCH
    with plant(fault):
        rc, line = run("dtu-r", seed=2 ** 31 + 5, seconds=1, bench=BENCH)
    print("dtu-r", fault, "rc", rc, json.dumps(line and line["checks"]),
          flush=True)
    assert rc != 0 or not line["correct"]
