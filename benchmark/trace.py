"""Reduction of one profiled job's ``torch.profiler`` trace.

``busy_s`` is the union of the device's intervals (kernels, copies,
sets), as ``chip_smoke.py::device_busy_s`` at commit 04b33df computes it;
the job's wall is the benchmark's own span around it. Idle gaps are the
holes in that union inside the job, each labelled by the innermost of the
benchmark's spans (``record_function`` ranges named ``bench/<label>``)
open at its midpoint: what the host was doing while the device waited.
The raw Kineto events are read (``kineto_results.events()``), not the
profiler's event tree, which takes minutes to build for a million
kernels.
"""

from __future__ import annotations

from collections import defaultdict

SPAN_PREFIX = "bench/"
JOB_SPAN = SPAN_PREFIX + "job"


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its return type, cut to ``width``."""
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_profile(prof, top: int = 10) -> dict:
    """busy_s, wall_s, device seconds by kernel name, and idle seconds by
    the host span open during each gap."""
    from torch.autograd import DeviceType
    device, spans = [], []
    by_name = defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():   # a host span mirrored on the GPU
                continue
            device.append((s, s + d))
            by_name[short_name(e.name())] += d
        elif e.name().startswith(SPAN_PREFIX):
            spans.append((s, s + d, e.name()[len(SPAN_PREFIX):]))
    job = [sp for sp in spans if sp[2] == "job"]
    if not job or not device:
        return {}
    j0, j1 = job[0][0], job[0][1]
    busy = merge((max(s, j0), min(e, j1)) for s, e in device
                 if e > j0 and s < j1)
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], j0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if j1 > prev:
        gaps.append((prev, j1))
    # the spans nest (one host thread): sweep the gaps in time order with
    # a stack of the spans open at each gap's midpoint
    inner = sorted((sp for sp in spans if sp[2] != "job"),
                   key=lambda sp: sp[0])
    idle, stack, i = defaultdict(int), [], 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(inner) and inner[i][0] <= mid:
            while stack and stack[-1][1] < inner[i][0]:
                stack.pop()
            stack.append(inner[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[stack[-1][2] if stack else "job, outside the spans"] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_ns / 1e9,
        "wall_s": (j1 - j0) / 1e9,
        "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
        "device_ops": [[k, v / 1e9] for k, v in ops],
        "idle_gaps": [[k, v / 1e9] for k, v in gaps_by],
    }
