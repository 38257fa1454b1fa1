"""The ``-r`` job: one whole reconstruction through the program's CLI.

``cli.main(["-r", "scene.nvm", "-o", <fresh dir>, "--device", ...])`` from
the scene's directory: NVM load, PNG decode, scene build, seed refinement,
the expansion with its autosaves, the writers. The CLI's output goes to a
buffer (its last lines to stderr). Each job's ``stats.json``, ``time1``
and ``exp.mvs`` are read, and its directory deleted before the next job.

Like the program's ``tools/gpu_4k_run.py`` (whose pattern this copies, and
which it does not import), the run wraps ``Reconstructor.expand`` to cap
the expansion where the configuration says so (and to one round in the
warm-up). Traced runs also open the benchmark's spans around the layers
(``record_function("bench/<layer>")``), time each autosave, and keep a
copy of the arguments of the first expansion-mode K1 call.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys
import time

import numpy as np

from benchmark import trace
from benchmark.reference import mvsfile

# the traffic file's keys that this mode reads (besides "mode" and "why")
TRAFFIC_KEYS = ("warmup_rounds", "sampled_patches")


class Job(dict):
    """One finished job: wall_s, time1_s, stats, patches, cloud (bytes),
    autosave_s (traced runs), profile (the profiled job)."""


class Patches:
    """Installs the run's wrappers on the program; ``restore`` undoes
    them."""

    def __init__(self, ctx):
        import torch
        from pais_mvs_tpu_torch import cli
        from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
        from pais_mvs_tpu_torch.ops import cuda_fitness as CF
        self.ctx, self.saved = ctx, []
        self.cap = ctx.cfg.get("expansion_round_cap")
        self.in_expansion = False
        self.in_autosave = False
        self.autosave_s = []
        self.k1_args = None
        traced = bool(ctx.trace)

        def patch(owner, name, make):
            orig = getattr(owner, name)
            self.saved.append((owner, name, orig))
            setattr(owner, name, make(orig))

        def span(label):
            def make(orig):
                def call(*a, **k):
                    with torch.profiler.record_function(trace.SPAN_PREFIX
                                                        + label):
                        return orig(*a, **k)
                return call
            return make

        def expand(orig):
            def call(rec, max_rounds=10_000, autosave_path=None):
                cap = self.round_cap
                self.in_expansion = True
                try:
                    with torch.profiler.record_function(
                            trace.SPAN_PREFIX + "expansion host"):
                        return orig(rec, max_rounds=(max_rounds if cap is None
                                                     else cap),
                                    autosave_path=autosave_path)
                finally:
                    self.in_expansion = False
            return call

        self.round_cap = self.cap
        patch(Reconstructor, "expand", expand)
        if not traced:
            return

        def save(orig):
            def call(rec, path):
                self.in_autosave = True
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function(trace.SPAN_PREFIX
                                                        + "autosave"):
                        return orig(rec, path)
                finally:
                    self.autosave_s.append(time.perf_counter() - t0)
                    self.in_autosave = False
            return call

        def write_mvs(orig):
            def call(rec, *a, **k):
                if self.in_autosave:
                    return orig(rec, *a, **k)
                with torch.profiler.record_function(trace.SPAN_PREFIX
                                                    + "writers"):
                    return orig(rec, *a, **k)
            return call

        def k1(orig):
            def call(*a, **k):
                if (self.k1_args is None and self.in_expansion
                        and a[2].is_cuda
                        and not torch.cuda.is_current_stream_capturing()):
                    self.k1_args = tuple(
                        x.clone() if isinstance(x, torch.Tensor) else x
                        for x in a)
                return orig(*a, **k)
            return call

        patch(cli, "_build_reconstructor", span("scene build"))
        patch(Reconstructor, "refine_seeds", span("seeds"))
        patch(Reconstructor, "_refine_all_async", span("refine launch"))
        patch(Reconstructor, "_refine_fetch", span("refine fetch wait"))
        patch(Reconstructor, "save_checkpoint", save)
        patch(Reconstructor, "write_mvs", write_mvs)
        patch(Reconstructor, "write_ply", span("writers"))
        patch(Reconstructor, "write_psr", span("writers"))
        patch(CF, "score_windows", k1)

    def restore(self):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)
        self.saved.clear()


def prepare(ctx):
    """Render the scene from the seed and write the CLI's files."""
    from benchmark import scenes
    scene = scenes.render(ctx.cfg["scene"], ctx.cfg, ctx.seed, ctx.device)
    ctx.scene = scene
    ctx.scene_dir = os.path.join(ctx.work, "scene")
    scenes.write_files(scene, ctx.cfg, ctx.scene_dir)
    scene.images = None       # the PNGs are what the program reads
    ctx.patches = Patches(ctx)


def _cli(ctx, out_dir):
    import torch
    from pais_mvs_tpu_torch import cli
    buf = io.StringIO()
    here = os.getcwd()
    os.chdir(ctx.scene_dir)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-r", "scene.nvm", "-o", out_dir, "--device",
                           str(ctx.device)])
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        os.chdir(here)
    lines = buf.getvalue().splitlines()
    if rc != 0:
        sys.stderr.write("\n".join(lines[-40:]) + "\n")
        raise RuntimeError(f"cli -r exited {rc}")
    return lines


def warmup(ctx):
    """One job of the scene with the expansion held to the traffic's
    warm-up rounds: every kernel loaded, every graph key captured once."""
    p = ctx.patches
    p.round_cap = int(ctx.traffic["warmup_rounds"])
    try:
        out = os.path.join(ctx.work, "warmup")
        _cli(ctx, out)
        shutil.rmtree(out)
    finally:
        p.round_cap = p.cap
        p.autosave_s.clear()
        p.k1_args = None


def job(ctx, index: int, profile: bool = False) -> Job:
    import torch
    out = os.path.join(ctx.work, f"job{index}")
    p = ctx.patches
    n_saves = len(p.autosave_s)
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        with prof:
            with torch.profiler.record_function(trace.JOB_SPAN):
                t0 = time.perf_counter()
                lines = _cli(ctx, out)
                wall = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        lines = _cli(ctx, out)
        wall = time.perf_counter() - t0
    time1 = float(next(ln for ln in lines
                       if ln.startswith("time1\t")).split("\t")[1])
    with open(os.path.join(out, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(out, "exp.mvs"), "rb") as f:
        cloud = f.read()
    shutil.rmtree(out)
    rec = Job(wall_s=wall, time1_s=time1, stats=stats, cloud=cloud,
              patches=mvsfile.count_patches(cloud),
              autosave_s=(sum(p.autosave_s[n_saves:]) if ctx.trace
                          else None))
    if prof is not None:
        rec["profile"] = trace.reduce_profile(prof)
    return rec


def k1_timing(ctx):
    """(bound ms, what bounds it, K1 device ms) on the arguments of the
    first expansion-mode K1 call of the traced run, K1 timed by CUDA events
    after the window; None if no such call was seen."""
    import torch
    from benchmark import roofline
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    p = ctx.patches
    if p.k1_args is None:
        return None
    pyrs, cfg, H, pt, ref, mask, lod, pvalid = p.k1_args[:8]
    active = p.k1_args[8] if len(p.k1_args) > 8 else None
    bound, by = roofline.k1_bound_ms(pyrs, cfg.patch_radius,
                                     cfg.adaptive_gradient_enable, H, pt,
                                     ref, mask, lod, pvalid, active)
    fn = lambda: CF.score_windows(*p.k1_args)
    for _ in range(3):
        fn()
    reps = 20
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    p.k1_args = None
    return bound, by, e0.elapsed_time(e1) / reps


def samples(seed: int, clouds, total: int):
    """The patches the reference judges: ``total`` drawn by the seed,
    spread evenly over the jobs' clouds (``mvsfile.Cloud``; all of a
    smaller cloud), so a run judges as many however many jobs it held."""
    from benchmark.reference.check import Sample
    rng = np.random.default_rng([seed, 7])
    J = len(clouds)
    parts = []
    for j, cloud in enumerate(clouds):
        M = len(cloud.centers)
        k = total // J + (j < total % J)
        idx = np.sort(rng.choice(M, size=min(k, M), replace=False))
        parts.append([a[idx] for a in cloud])
    cat = [np.concatenate([p[i] for p in parts]) for i in range(5)]
    return Sample(*cat)


def check(ctx, jobs) -> dict:
    """The reference's readings of the jobs' clouds (``program``; with
    ``ctx.control`` also ``control``, the reference one precision step
    down in the program's place). Runs after the window, once the
    program's state is freed."""
    import torch
    from benchmark.reference.check import readings
    from benchmark.reference.photo import RefScene, engine_params
    params = engine_params(ctx.cfg["config_txt"])
    cams = ctx.scene.cameras
    clouds = [mvsfile.parse_cloud(j["cloud"]) for j in jobs]
    sample = samples(ctx.seed, clouds, int(ctx.traffic["sampled_patches"]))
    surf = ctx.scene.surface
    dist = np.concatenate([surf.distance(c.centers) for c in clouds])
    ref = RefScene(ctx.scene_dir, cams, params, ctx.device)
    ctl = (RefScene(ctx.scene_dir, cams, params, ctx.device,
                    dtype=torch.bfloat16, quantize="fp8")
           if ctx.control else None)
    out = readings(ref, ctl, sample, surf)
    out["surface_dist_median"] = float(np.median(dist))
    out["cloud_patches"] = [j["patches"] for j in jobs]
    del ref, ctl
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out
