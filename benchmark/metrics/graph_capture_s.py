"""Seconds per job capturing the refine's CUDA graphs (``stats.json``
``refine_graph_capture_s``)."""
from benchmark.metrics import per_job


def read(run):
    return per_job(run, lambda j: j["stats"].get("refine_graph_capture_s"))
