"""The expansion's host time per job (``stats.json``
``expansion_host_s``: the expansion's wall less the refines' spans)."""
from benchmark.metrics import per_job


def read(run):
    return per_job(run, lambda j: j["stats"].get("expansion_host_s"))
