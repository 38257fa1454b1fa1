"""Seconds per job preparing the expansion rounds: the wavefront pop,
the candidates (the native call) and their batch (``expand/prepare``)."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def read(run):
    return per_job(run, lambda j: span_s(j, "expand/prepare"))
