"""Seconds per job in each refine graph key's eager first run, with
the wait for its device work (``refine/first_run``)."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def read(run):
    return per_job(run, lambda j: span_s(j, "refine/first_run"))
