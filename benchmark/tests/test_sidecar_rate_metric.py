"""The reader of ``autosave_sidecar_MBps`` on hand-made jobs: the sidecar's
raw bytes over its span's seconds, averaged over the jobs, and None for a
job without a ``trace``, without the counter (a program that does not
count it) or without a sidecar written."""

import types

import pytest

from benchmark.metrics import autosave_sidecar_MBps


def job(raw=12_000_000, sidecar_s=0.5, trace=True):
    stats = {}
    if trace:
        counters = {"autosaves": 8, "autosave_bytes": 9_000_000}
        if raw is not None:
            counters["sidecar_raw_bytes"] = raw
        spans = {"job": {"n": 1, "total_s": 9.0, "self_s": 0.25}}
        if sidecar_s is not None:
            spans["autosave/sidecar"] = {"n": 8, "total_s": sidecar_s,
                                         "self_s": sidecar_s}
        stats["trace"] = {"spans": spans, "counters": counters,
                          "rounds": []}
    return {"stats": stats, "wall_s": 9.5, "time1_s": 9.2}


def read(*jobs):
    return autosave_sidecar_MBps.read(types.SimpleNamespace(jobs=list(jobs)))


def test_reads_raw_bytes_over_the_sidecar_span():
    assert read(job()) == pytest.approx(24.0)
    assert read(job(), job(raw=6_000_000, sidecar_s=1.0)) == \
        pytest.approx((24.0 + 6.0) / 2)


@pytest.mark.parametrize("kind", ["no_trace", "no_counter", "no_sidecar"])
def test_reads_nothing_without_what_it_reads(kind):
    j = {"no_trace": job(trace=False), "no_counter": job(raw=None),
         "no_sidecar": job(raw=None, sidecar_s=None)}[kind]
    assert read(j) is None
    assert read(job(), j) is None
