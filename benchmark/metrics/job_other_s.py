"""Seconds per job that no span below the CLI's ``job`` span covers
(its self time: NVM load, configuration, the seeds' neighbour radius,
the gaps between the layers)."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def read(run):
    return per_job(run, lambda j: span_s(j, "job", "self_s"))
