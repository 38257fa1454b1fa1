"""The share of refined rows that see more cameras than one K1 block
holds, in percent: 100 x counter ``k1_tiled_rows`` / ``refined_rows``
(every row refined, padding included). None for a program that does not
count them.

Descriptive, not a target, like ``cams_per_row``: it reads which of K1's
paths the rig's rows take, set by the cameras the rule admits and by the
tile's width; ``better`` in BENCHMARK.json only fills the field every
metric must carry."""
from benchmark.metrics import per_job
from benchmark.program_trace import counter


def share(j):
    trace = j["stats"].get("trace")
    if trace is None or "k1_tiled_rows" not in trace["counters"]:
        return None
    rows = counter(j, "refined_rows")
    if not rows:
        return None
    return 100.0 * counter(j, "k1_tiled_rows") / rows


def read(run):
    return per_job(run, share)
