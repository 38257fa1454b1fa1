"""Seconds per job in the seed refine's rounds, filter and insert
(``seeds``)."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def read(run):
    return per_job(run, lambda j: span_s(j, "seeds"))
