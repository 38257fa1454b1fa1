"""Seconds per job inserting the refined candidates, the autosaves left
out (``expand/insert`` self time)."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def read(run):
    return per_job(run, lambda j: span_s(j, "expand/insert", "self_s"))
