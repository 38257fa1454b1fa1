"""The scene build per job: the CLI's wall less its printed time1 (NVM
load, PNG decode, ``build_scene``)."""
from benchmark.metrics import per_job


def read(run):
    return per_job(run, lambda j: j["wall_s"] - j["time1_s"])
