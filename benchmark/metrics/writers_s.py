"""The writers per job: the CLI's time1 less the seed refinement and the
expansion (init, seed and exp ``.mvs``, the PLY, the PSR, stats)."""
from benchmark.metrics import per_job


def read(run):
    return per_job(run, lambda j: j["time1_s"] - j["stats"]["seed_refine_s"]
                   - j["stats"]["expansion_s"])
