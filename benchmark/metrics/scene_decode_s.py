"""Seconds per job decoding the cameras' PNGs (``scene/decode``)."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def read(run):
    return per_job(run, lambda j: span_s(j, "scene/decode"))
