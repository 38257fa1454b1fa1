"""K1's device seconds in the profiled job (the profiler's kernels named
``fitness_kernel``)."""


def read(run):
    ks = run.profile.get("kernel_s", {})
    hits = [v for k, v in ks.items() if "fitness_kernel" in k]
    return sum(hits) if hits else None
