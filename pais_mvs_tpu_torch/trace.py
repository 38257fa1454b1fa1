"""One job's nested spans and counters, on the host's clock and, while a
profiler records, on its timeline too.

``Trace.span(name, round=None)`` is a context manager. Each span records
its name, its start and end on ``time.perf_counter_ns``, the span it
opened inside (its parent) and the expansion round it belongs to: given,
or else its parent's. ``Trace.count(name, n)`` adds to a job counter and,
inside a span of a round, to that round's. Spans stay in memory for the
job; ``Trace.summary()`` is what ``stats.json`` carries as ``trace``:

  * ``spans``: per name, the count ``n``, the total ``total_s`` and the
    self time ``self_s`` (the total less the part its child spans cover);
  * ``counters``;
  * ``rounds``: one row per expansion round (``ROUND_COLUMNS``).

While ``torch.profiler`` records (``profiling()``), every span also opens
``torch.profiler.record_function(name)`` (``name round=<id>`` for a span
opened with its round), so the program's spans lie on the profiler's
timeline beside the device's kernels, on one clock. Otherwise no
``record_function`` is made and nothing is formatted: a span costs two
clock reads and a few list and dict updates. ``idle_report`` reduces such
a profile to the device's busy share over the ``job`` span and its idle
seconds by the innermost program span open in each gap.

The port's spans, from the CLI down (``cli.py``,
``engine/reconstructor.py``, ``ops/graphs.py``, ``models/camera.py``):

  job                   a CLI job (NVM load and config in its self time)
  scene/decode          the PNG decode (``cli._load_images``)
  scene/build           ``build_scene``: scene/undistort, scene/upload and
                        scene/pyramid (one each a camera) inside
  seeds/load, seeds     the seeds' ingest; their refine rounds. A
                        point-less NVM seeds from features inside
                        seeds/load: features/detect (one a camera),
                        features/match, features/tracks
                        (``features/seeding.py``)
  expand                the expansion: expand/grids, then expand/round
                        (one a round, with its id) holding
                        expand/prepare (expand/candidates inside),
                        refine/enqueue, refine/fetch and expand/insert
                        (autosave inside)
  refine/enqueue        ``_refine_all_async``: per chunk refine/wait (the
                        card's stream drained, as the chunk's index
                        upload would), refine/chunk, then refine/draws,
                        refine/stage, refine/replay, refine/clone, or a
                        key's refine/first_run and refine/capture
  autosave              autosave/mvs, autosave/sidecar (the sidecar's
                        deflate, write and rename), autosave/snapshot
  writers               init, seed and exp ``.mvs``, PLY, PSR

and its counters: rounds, parents, candidates, refined_rows (padding
included), padded_rows, scored_cams (the cameras the seeds and the
expansion's candidates enter the refine with, summed over their rows from
the host's masks; the distributed expansion's candidates, made on the
device, are not counted), k1_tiled_rows (those rows that see more cameras
than K1's one-pass rig holds, ``cuda_fitness.CAMERA_TILE``),
k1_resampled_rows (those that see more than a wide K1 block holds,
``cuda_fitness.CAMERA_SPAN``, so that K1 samples part of them twice),
inserted, autosaves, autosave_bytes,
sidecar_raw_bytes (the sidecars' ``.npy`` bytes deflated), deflate_blocks
(the blocks handed to the deflate pool), fetch_bytes, from
``RefineGraphs.counts`` graph_keys_captured, graph_first_runs and
graph_replays, geometry_launches and fitness_launches (the launches of
the refine's geometry kernel and of K1, ``cuda_fitness.LAUNCHES`` counted
around each of the job's refines, graph replays included: equal on a job
whose fitness runs on the card, every K1 call's geometry ran on the
kernel; 0 on the CPU); from the feature seeding keypoints,
pairs_matched, pairs_kept, pair_matches, tracks and feature_seeds
(``features/seeding.py``'s note); deflate_threads (the deflate pool's width) is set, not
summed (``Trace.set``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

# whether a profiler records; measurement scripts may replace it
profiling = torch._C._autograd._profiler_enabled

# the rounds table: column -> (span name, "total_s" or "self_s")
ROUND_COLUMNS = {
    "prepare_s": ("expand/prepare", "total_s"),
    "enqueue_s": ("refine/enqueue", "total_s"),
    "fetch_s": ("refine/fetch", "total_s"),
    "insert_s": ("expand/insert", "self_s"),
    "autosave_s": ("autosave", "total_s"),
}
ROUND_COUNTERS = ("parents", "candidates", "refined_rows", "inserted")
JOB = "job"
# a span opened with its round is named "<name> round=<id>" on the
# profiler's timeline (its children inherit the round by nesting)
ROUND_TAG = " round="


class Span:
    """One span of a ``Trace``; ``seconds`` once it has closed."""

    __slots__ = ("trace", "name", "round", "parent", "start", "end",
                 "child_ns", "_rf")

    def __init__(self, trace: "Trace", name: str, round: Optional[int]):
        self.trace = trace
        self.name = name
        self.round = round
        self.child_ns = 0

    def __enter__(self) -> "Span":
        tr = self.trace
        stack = tr._stack
        given = self.round
        if stack:
            parent = self.parent = stack[-1]
            if given is None:
                self.round = parent.round
        else:
            self.parent = None
        if profiling():
            self._rf = torch.profiler.record_function(
                self.name if given is None
                else f"{self.name}{ROUND_TAG}{given}")
            self._rf.__enter__()
        else:
            self._rf = None
        stack.append(self)
        self.start = tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self.trace
        end = self.end = tr.clock()
        tr._stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self.parent is not None:
            self.parent.child_ns += end - self.start
        tr.spans.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def self_ns(self) -> int:
        return self.end - self.start - self.child_ns


class Trace:
    """The spans and counters of one job (one thread: spans nest)."""

    def __init__(self, clock=time.perf_counter_ns):
        self.clock = clock
        self.spans: List[Span] = []          # closed, in closing order
        self.counters: Dict[str, int] = {}
        self._round_counters: Dict[int, Dict[str, int]] = {}
        self._stack: List[Span] = []

    def span(self, name: str, round: Optional[int] = None) -> Span:
        return Span(self, name, round)

    def count(self, name: str, n: int = 1) -> None:
        c = self.counters
        c[name] = c.get(name, 0) + n
        if self._stack:
            r = self._stack[-1].round
            if r is not None:
                rc = self._round_counters.setdefault(r, {})
                rc[name] = rc.get(name, 0) + n

    def set(self, name: str, n: int) -> None:
        """Set a job counter that holds a level, not a sum."""
        self.counters[name] = n

    def total(self, name: str) -> float:
        """Seconds in the closed spans called ``name``."""
        return sum(s.end - s.start for s in self.spans
                   if s.name == name) / 1e9

    def seconds(self, name: str) -> List[float]:
        """Each closed span called ``name``, in seconds, in order."""
        return [s.seconds for s in self.spans if s.name == name]

    def summary(self) -> dict:
        agg: Dict[str, list] = {}            # name -> [n, total, self] ns
        for sp in self.spans:
            a = agg.get(sp.name)
            if a is None:
                a = agg[sp.name] = [0, 0, 0]
            a[0] += 1
            a[1] += sp.end - sp.start
            a[2] += sp.self_ns
        spans = {name: {"n": n, "total_s": t / 1e9, "self_s": s / 1e9}
                 for name, (n, t, s) in agg.items()}
        cols = {name: (col, kind) for col, (name, kind)
                in ROUND_COLUMNS.items()}
        per = defaultdict(lambda: dict.fromkeys(ROUND_COLUMNS, 0.0))
        for sp in self.spans:
            if sp.round is not None and sp.name in cols:
                col, kind = cols[sp.name]
                ns = sp.end - sp.start if kind == "total_s" else sp.self_ns
                per[sp.round][col] += ns / 1e9
        rounds = []
        for r in sorted(set(per) | set(self._round_counters)):
            rc = self._round_counters.get(r, {})
            rounds.append({"round": r,
                           **{k: rc.get(k, 0) for k in ROUND_COUNTERS},
                           **per[r]})
        return {"spans": spans, "counters": dict(self.counters),
                "rounds": rounds}


def idle_by_span(busy, spans, job) -> Dict[str, int]:
    """The device's idle time inside ``job`` (start, end) by the
    innermost of ``spans`` ((start, end, name), nested; open on
    [start, end)) at each gap's midpoint; ``JOB`` where none is.
    ``busy`` is the sorted, disjoint union of the device's intervals.
    Same units as given."""
    j0, j1 = job
    gaps, prev = [], j0
    for s, e in busy:
        if e <= j0 or s >= j1:
            continue
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if j1 > prev:
        gaps.append((prev, j1))
    inner = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    idle: Dict[str, int] = defaultdict(int)
    stack: list = []
    i = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(inner) and inner[i][0] <= mid:
            while stack and stack[-1][1] <= inner[i][0]:
                stack.pop()
            stack.append(inner[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        idle[stack[-1][2] if stack else JOB] += e - s
    return dict(idle)


def merge(intervals) -> List[list]:
    """Sorted, disjoint union of (start, end) intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_report(prof, names, top: int = 10) -> dict:
    """``--profile``'s ``idle.json`` from a finished ``torch.profiler``
    run: over the ``job`` span, the device's busy seconds and share, its
    idle seconds by the innermost program span (of ``names``) open in
    each gap, and its top ops by device seconds. The raw Kineto events
    are read, not the profiler's event tree. Without device activity (the
    CPU) there is nothing to attribute, and the device's numbers are
    null."""
    from torch.autograd import DeviceType
    device, spans, job = [], [], None
    by_name: Dict[str, int] = defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((s, s + d))
                by_name[e.name()] += d
        elif e.is_user_annotation():
            name = e.name().split(ROUND_TAG)[0]
            if name == JOB:
                job = job or (s, s + d)
            elif name in names:
                spans.append((s, s + d, name))
    out = {"job_s": None if job is None else (job[1] - job[0]) / 1e9,
           "busy_s": None, "busy_share": None, "idle_by_span": None,
           "device_ops": None}
    if job is None or not device:
        return out
    j0, j1 = job
    busy = merge((max(s, j0), min(e, j1)) for s, e in device
                 if e > j0 and s < j1)
    busy_ns = sum(e - s for s, e in busy)
    idle = idle_by_span(busy, [sp for sp in spans
                               if sp[1] > j0 and sp[0] < j1], job)
    out.update(
        busy_s=busy_ns / 1e9, busy_share=busy_ns / (j1 - j0),
        idle_by_span=[[k, v / 1e9] for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])],
        device_ops=[[k, v / 1e9] for k, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:top]])
    return out
