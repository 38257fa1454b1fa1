"""What the per-layer metrics of the program's own spans and counters read:
``stats.json``'s ``trace`` (``pais_mvs_tpu_torch/trace.py``), per job.

Each reader returns None for a job whose ``stats.json`` has no ``trace``
(a program without these spans), and 0 for a span the job never opened
or a counter it never moved (that work did not run)."""


def span_s(job, name: str, key: str = "total_s"):
    """Seconds of the job's spans called ``name``: their ``total_s`` or
    ``self_s``."""
    trace = job["stats"].get("trace")
    if trace is None:
        return None
    return trace["spans"].get(name, {}).get(key, 0.0)


def spans_s(job, names):
    """The summed totals of the job's spans called ``names``."""
    parts = [span_s(job, n) for n in names]
    return None if None in parts else sum(parts)


def counter(job, name: str):
    """The job's counter ``name``."""
    trace = job["stats"].get("trace")
    if trace is None:
        return None
    return trace["counters"].get(name, 0)
