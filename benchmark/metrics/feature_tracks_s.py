"""Seconds per job in the feature seeding's ``features/tracks`` span (the
kept matches' union into tracks, their triangulation and colours); None
where the job has no such span (a program without it)."""
from benchmark.metrics import per_job
from benchmark.metrics.feature_pair_ms import feature_span_s


def read(run):
    return per_job(run, lambda j: feature_span_s(j, "features/tracks"))
