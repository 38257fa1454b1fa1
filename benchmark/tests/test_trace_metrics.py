"""The readers of the program's own spans and counters (``stats.json``'s
``trace``) on hand-made jobs: each number as its entry defines it, averaged
over the jobs, and None for a job without a ``trace`` (a program that
records none)."""

import importlib
import types

import pytest

SPANS = {
    "job": {"n": 1, "total_s": 9.0, "self_s": 0.25},
    "scene/decode": {"n": 1, "total_s": 0.125, "self_s": 0.125},
    "seeds": {"n": 1, "total_s": 0.5, "self_s": 0.0625},
    "expand/prepare": {"n": 40, "total_s": 0.75, "self_s": 0.5},
    "expand/insert": {"n": 39, "total_s": 3.5, "self_s": 0.375},
    "autosave/sidecar": {"n": 30, "total_s": 2.75, "self_s": 2.75},
    "refine/enqueue": {"n": 42, "total_s": 4.0, "self_s": 0.5},
    "refine/first_run": {"n": 3, "total_s": 0.625, "self_s": 0.625},
    "refine/capture": {"n": 3, "total_s": 1.0, "self_s": 1.0},
    "refine/chunk": {"n": 80, "total_s": 0.25, "self_s": 0.25},
    "refine/stage": {"n": 78, "total_s": 0.5, "self_s": 0.5},
    "refine/clone": {"n": 78, "total_s": 0.125, "self_s": 0.125},
    "refine/fetch": {"n": 39, "total_s": 0.375, "self_s": 0.375},
    "refine/wait": {"n": 80, "total_s": 2.5, "self_s": 2.5},
}
COUNTERS = {"autosave_bytes": 123_456_789, "inserted": 20_000,
            "refined_rows": 80_000}
EXPECTED = {
    "job_other_s": 0.25,
    "scene_decode_s": 0.125,
    "seed_refine_s": 0.5,
    "expansion_prepare_s": 0.75,
    "expansion_insert_s": 0.375,
    "autosave_sidecar_s": 2.75,
    "autosave_MB": 123.456789,
    "refine_enqueue_s": 4.0 - 0.625 - 1.0,
    "refine_copies_s": 0.25 + 0.5 + 0.125,
    "refine_fetch_s": 0.375,
    "graph_first_run_s": 0.625,
    "refine_useful_share": 25.0,
    "refine_wait_s": 2.5,
}


def job(scale=1.0, trace=True):
    stats = {"seed_refine_s": 0.5}
    if trace:
        stats["trace"] = {
            "spans": {k: {"n": v["n"], "total_s": v["total_s"] * scale,
                          "self_s": v["self_s"] * scale}
                      for k, v in SPANS.items()},
            "counters": {k: int(v * scale) for k, v in COUNTERS.items()},
            "rounds": []}
    return {"stats": stats, "wall_s": 9.5, "time1_s": 9.2}


def run(*jobs):
    return types.SimpleNamespace(jobs=list(jobs))


def read(name, r):
    return importlib.import_module(f"benchmark.metrics.{name}").read(r)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_trace(name):
    assert read(name, run(job())) == pytest.approx(EXPECTED[name])
    # a mean over the window's jobs (the share is scale-free)
    mean = read(name, run(job(1.0), job(3.0)))
    want = EXPECTED[name] * (1 if name == "refine_useful_share" else 2)
    assert mean == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_a_trace_reads_nothing(name):
    assert read(name, run(job(trace=False))) is None
    assert read(name, run(job(), job(trace=False))) is None


def test_a_span_never_opened_reads_zero():
    j = job()
    for k in ("refine/first_run", "refine/capture", "refine/stage",
              "refine/clone", "refine/wait"):
        del j["stats"]["trace"]["spans"][k]
    assert read("graph_first_run_s", run(j)) == 0.0
    assert read("refine_wait_s", run(j)) == 0.0
    assert read("refine_enqueue_s", run(j)) == pytest.approx(4.0)
    assert read("refine_copies_s", run(j)) == pytest.approx(0.25)
