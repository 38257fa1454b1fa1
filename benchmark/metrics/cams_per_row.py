"""Cameras a refined row enters the refine with, on average: counter
``scored_cams`` (each seed's and expansion candidate's visible cameras,
summed) / ``refined_rows`` (every row refined, padding included, which
enters with none). None for a program that does not count them.

Descriptive, not a target: it reads how many cameras the visible-camera
rule admits, which is the mathematics of the result. A change that lowers
it by scoring fewer cameras changes the answers, and the comparison
(``correct``), not this number, judges it; ``better`` in BENCHMARK.json
only fills the field every metric must carry."""
from benchmark.metrics import per_job
from benchmark.program_trace import counter


def per_row(j):
    cams, rows = counter(j, "scored_cams"), counter(j, "refined_rows")
    if not cams or not rows:
        return None
    return cams / rows


def read(run):
    return per_job(run, per_row)
