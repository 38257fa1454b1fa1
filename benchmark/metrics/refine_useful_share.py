"""The share of refined rows that became patches: 100 x counter
``inserted`` (seeds accepted and expansion inserts) / ``refined_rows``
(every row refined, padding included)."""
from benchmark.metrics import per_job
from benchmark.program_trace import counter


def share(j):
    ins, rows = counter(j, "inserted"), counter(j, "refined_rows")
    if ins is None or not rows:
        return None
    return 100.0 * ins / rows


def read(run):
    return per_job(run, share)
