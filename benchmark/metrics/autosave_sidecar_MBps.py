"""Megabytes a second per job through the autosaves' sidecar writer: the
raw ``.npy`` bytes it deflated (counter ``sidecar_raw_bytes``) over the
seconds of its ``autosave/sidecar`` spans. None for a job whose program
does not count those bytes, or that wrote no sidecar."""
from benchmark.metrics import per_job
from benchmark.program_trace import span_s


def rate(j):
    trace = j["stats"].get("trace")
    raw = None if trace is None else \
        trace["counters"].get("sidecar_raw_bytes")
    s = span_s(j, "autosave/sidecar")
    if not raw or not s:
        return None
    return raw / 1e6 / s


def read(run):
    return per_job(run, rate)
