"""K1's share of its roofline, in percent: the bound (``roofline.py``, on
the arguments of the traced run's first expansion-mode K1 call) over K1's
time on those arguments (CUDA events, after the window)."""


def read(run):
    if run.k1 is None or run.k1[2] <= 0:
        return None
    return 100.0 * run.k1[0] / run.k1[2]
