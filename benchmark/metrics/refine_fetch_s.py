"""Seconds per job fetching the expansion's refines: the host's wait,
the copy to the host and the merge (``refine/fetch``)."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def read(run):
    return per_job(run, lambda j: span_s(j, "refine/fetch"))
