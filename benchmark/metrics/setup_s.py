"""Seconds from the process's start to the window's: imports, the kernels'
load, the scene's render and files, and the warm-up."""


def read(run):
    return run.setup_s
