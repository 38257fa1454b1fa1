"""Run one cell of the benchmark once on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell (``workloads/<cell>.json``) names a
configuration (``configs/<name>.json``: the scene kind, its sizes and the
program's ``config.txt``) and a traffic mix (``traffic/<name>.json``: the
job mode, ``modes/<mode>.py``, and its parameters). A run renders the
scene from the seed, writes the program's input files under ``TMPDIR``,
warms up with one job held to the traffic's warm-up rounds, then runs
whole jobs back to back (one client, closed loop) and closes the window at
the first job boundary at or after ``--seconds``. After the window the
reference judges the jobs' outputs (``correct``). The last line of
standard output is one JSON object: with ``--trace 0`` the cell's
end-to-end metrics of ``BENCHMARK.json``, with ``--trace 1`` its
per-layer metrics, each read by ``metrics/<name>.py`` (a traced run also
runs one more job after the window, under ``torch.profiler``). The
numbers compared and their limits close standard error and the JSON line
(``checks``).

Exits non-zero and prints no result without a CUDA device (or with fewer
than the cell asks for), when a job fails, or when a module of JAX or of
the JAX package was loaded.
"""

from __future__ import annotations

import os
import time


def process_start() -> float:
    """The wall-clock time at which this process started (Linux /proc),
    or now where /proc says nothing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# the top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "pais_mvs_tpu")


def load(kind: str, name: str, bench: str = BENCH) -> dict:
    with open(os.path.join(bench, kind, f"{name}.json")) as f:
        return json.load(f)


def metric_entries(cell: str, trace: bool, bench_json: str) -> list:
    """The cell's metrics in ``BENCHMARK.json``: end-to-end ones without a
    trace, per-layer ones with it; an entry with a ``workloads`` list
    applies to those cells only."""
    with open(bench_json) as f:
        spec = json.load(f)
    entries = spec["per_layer" if trace else "end_to_end"]
    return [e for e in entries if cell in e.get("workloads", [cell])]


def module(kind: str, name: str, bench: str = BENCH):
    """``<bench>/<kind>/<name>.py`` as a module (the benchmark's own
    package when ``bench`` is this folder or holds no such file)."""
    path = os.path.join(bench, kind, f"{name}.py")
    if os.path.abspath(bench) == BENCH or not os.path.exists(path):
        return importlib.import_module(f"benchmark.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_power() -> str:
    """The card's name and power limit as nvidia-smi reports them (the
    roofline shares are against the 700 W data-sheet peaks)."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def compare(readings: dict, limits: dict) -> dict:
    """Each number compared beside its limit; a number passes at or under
    its limit."""
    return {k: {"value": readings.get(k), "limit": v}
            for k, v in limits.items()}


def run_cell(args, device=None, bench: str = BENCH,
             bench_json: str = None) -> int:
    """One run of cell ``args.workload``. ``device`` None means the card
    (and its checks); tests pass the CPU."""
    import numpy as np
    import torch
    cell = load("workloads", args.workload, bench)
    cfg = load("configs", cell["config"], bench)
    traffic = load("traffic", cell["traffic"], bench)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < int(cell["chips"]):
            print(f"the cell needs {cell['chips']} devices, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    mode = module("modes", traffic["mode"], bench)
    unknown = set(traffic) - {"mode", "why"} - set(mode.TRAFFIC_KEYS)
    if unknown:
        print(f"traffic {cell['traffic']}: mode {traffic['mode']} does not "
              f"implement {', '.join(sorted(unknown))}", file=sys.stderr)
        return 2
    work = tempfile.mkdtemp(prefix="pais-bench-")
    # what one run knows: the cell, its configuration and traffic, the
    # seed, the device, the work directory, and what the mode adds
    ctx = types.SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, seed=int(args.seed),
        trace=bool(args.trace), device=device, work=work,
        control=bool(getattr(args, "control", 0)))
    jobs, failed = [], 0
    try:
        try:
            mode.prepare(ctx)
            mode.warmup(ctx)
        except Exception:
            traceback.print_exc()
            print("the set-up failed: no result", file=sys.stderr)
            return 5
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        setup_s = t0 - T_START
        while True:
            try:
                jobs.append(mode.job(ctx, len(jobs)))
            except Exception:
                traceback.print_exc()
                failed += 1
                break
            if time.time() - t0 >= args.seconds:
                break
        window_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        profile, k1 = {}, None
        if ctx.trace and not failed:
            # one more job, after the window, under the profiler
            profile = mode.job(ctx, len(jobs), profile=True)["profile"]
            k1 = mode.k1_timing(ctx) if on_card else None
        ctx.patches.restore()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        readings = mode.check(ctx, jobs) if jobs else {}
    finally:
        if getattr(ctx, "patches", None) is not None:
            ctx.patches.restore()
        shutil.rmtree(work, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    if failed:
        print("a job failed: no result", file=sys.stderr)
        return 5
    # what the metric readers read: the window's jobs and times
    run = types.SimpleNamespace(jobs=jobs, window_s=window_s,
                                setup_s=setup_s, peak_bytes=peak, k1=k1,
                                profile=profile)
    metrics = {}
    for e in metric_entries(args.workload, ctx.trace,
                            bench_json or os.path.join(ROOT,
                                                       "BENCHMARK.json")):
        value = module("metrics", e["name"], bench).read(run)
        if value is not None:
            metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    # the control, where asked for, is judged in the program's place
    judged = readings.get("control" if ctx.control else "program", {})
    checks = compare(judged, cell.get("limits", {}))
    correct = bool(checks) and all(
        c["value"] is not None and np.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(jobs) + failed,
           "failed": failed, "metrics": metrics, "device": device_info}
    if ctx.trace and run.profile:
        device_info["busy_s"] = run.profile["busy_s"]
        device_info["window_s"] = run.profile["wall_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    if k1 is not None:
        out["k1"] = {"bound_ms": k1[0], "bound_by": k1[1], "ms": k1[2],
                     "card": card_power()}
    out["readings"] = dict(readings,
                           job_wall_s=[j["wall_s"] for j in jobs])
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control (the reference one precision "
                         "step down) in the program's place, and read the "
                         "reference's own depth sweep: the limits' upper "
                         "readings, with correct false; the benchmark's "
                         "runs leave it off")
    return run_cell(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
