"""Seconds per job the refine's enqueue waits for the card's stream to
drain before a chunk's index upload (``refine/wait``): the device's
refine of the chunk before, as the host sees it."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def read(run):
    return per_job(run, lambda j: span_s(j, "refine/wait"))
