"""Patches in the completed jobs' ``exp.mvs`` over the window's seconds."""


def read(run):
    return sum(j["patches"] for j in run.jobs) / run.window_s
