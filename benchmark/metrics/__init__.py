"""Metric readers, one module per metric of ``BENCHMARK.json``, found by
name. Each has ``read(run) -> float | None``: ``run`` is the namespace
that ``benchmark.run.run_cell`` fills (``jobs``, ``window_s``,
``setup_s``, ``peak_bytes``, ``profile``, ``k1``). A reader that finds nothing to read
returns None, and the run leaves the metric out."""


def per_job(run, value):
    """The mean over the run's jobs of ``value(job)``; None when a job has
    nothing to read."""
    vals = [value(j) for j in run.jobs]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
