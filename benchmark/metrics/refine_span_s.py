"""The refines' launch-to-completion spans per job (``stats.json``
``expansion_device_s``, CUDA events)."""
from benchmark.metrics import per_job


def read(run):
    return per_job(run, lambda j: j["stats"].get("expansion_device_s"))
