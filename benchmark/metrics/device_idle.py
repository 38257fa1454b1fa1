"""The device's idle share of the profiled job, in percent: one minus the
union of its CUDA intervals over the job's wall."""


def read(run):
    p = run.profile
    if not p or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
