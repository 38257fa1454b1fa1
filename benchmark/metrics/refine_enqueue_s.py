"""Seconds per job the host spends enqueuing the refine, seed rounds
and expansion (``refine/enqueue``), less the graph keys' first runs and
captures."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def enqueue(j):
    parts = [span_s(j, n) for n in ("refine/enqueue", "refine/first_run",
                                    "refine/capture")]
    return None if None in parts else parts[0] - parts[1] - parts[2]


def read(run):
    return per_job(run, enqueue)
