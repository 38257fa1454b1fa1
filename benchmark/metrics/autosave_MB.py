"""Megabytes per job the autosaves wrote: each ``.mvs`` and its sidecar
as written (counter ``autosave_bytes``)."""
from benchmark.metrics import per_job
from benchmark.program_trace import counter


def read(run):
    def mb(j):
        n = counter(j, "autosave_bytes")
        return None if n is None else n / 1e6
    return per_job(run, mb)
