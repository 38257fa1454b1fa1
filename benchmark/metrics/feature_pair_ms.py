"""Milliseconds per camera pair in the feature seeding's matching: the
``features/match`` span over the counter ``pairs_matched``, per job; None
where the job has no such span (a program without it)."""
from benchmark.metrics import per_job
from benchmark.program_trace import counter


def feature_span_s(job, name: str):
    """Seconds of the job's spans called ``name``, or None where it has
    none (``program_trace.span_s`` reads 0 there)."""
    spans = (job["stats"].get("trace") or {}).get("spans", {})
    return spans[name]["total_s"] if name in spans else None


def pair_ms(job):
    s = feature_span_s(job, "features/match")
    n = counter(job, "pairs_matched")
    return None if s is None or not n else 1e3 * s / n


def read(run):
    return per_job(run, pair_ms)
