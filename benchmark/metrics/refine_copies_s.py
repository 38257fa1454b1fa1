"""Seconds per job copying the refine's batches on the host's side: the
chunks' pad and take, the copies into a graph's static inputs and the
clones of its outputs (``refine/chunk`` + ``refine/stage`` +
``refine/clone``)."""
from benchmark.metrics import per_job
from benchmark.program_trace import spans_s


def read(run):
    return per_job(run, lambda j: spans_s(
        j, ("refine/chunk", "refine/stage", "refine/clone")))
