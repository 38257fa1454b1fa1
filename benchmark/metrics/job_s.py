"""Seconds per reconstruction: the window over the whole jobs it
completed (host clock)."""


def read(run):
    return run.window_s / len(run.jobs) if run.jobs else None
