"""Seconds per job writing the autosaves' ``.state.npz`` sidecars
(``savez_compressed`` and the rename: ``autosave/sidecar``)."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def read(run):
    return per_job(run, lambda j: span_s(j, "autosave/sidecar"))
