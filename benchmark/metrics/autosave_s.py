"""Seconds per job in ``Reconstructor.save_checkpoint`` (the benchmark's
own span, set in traced runs)."""
from benchmark.metrics import per_job


def read(run):
    return per_job(run, lambda j: j.get("autosave_s"))
