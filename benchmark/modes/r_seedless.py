"""The ``-r`` job of ``r.py`` on a rig whose NVM holds cameras and no
points, so that the program seeds from its own features (the upstream's
FeatureManager fallback, TMVS.cpp:98-103): the same jobs, warm-up and K1
timing (imported), the cloud judged as ``r_many_views`` judges it (its
``check``, imported: ``reference/check_many_views.py`` bounds the
admissible states to what a patch's last round can have held, and its
correlation table is a matrix product; ``reference/check.py`` would try
every one-camera addition from the whole rig, a few thousand states a
patch at 49 cameras, over a [rows, C, C, W2] table), and every job's
seeds judged by ``reference/features.py`` against its plain float64
pipeline on the same PNGs.

The run wraps ``pais_mvs_tpu_torch.features.generate_seed_patches`` to
keep each job's seeds (centres, camera masks, image points), inside a
``bench/feature seeding`` profiler span so that the breakdown's idle gaps
carry the label; ``restore`` (``r.Patches``) puts it back.
"""

from __future__ import annotations

import numpy as np

from benchmark import trace
from benchmark.modes import r
from benchmark.modes import r_many_views
from benchmark.modes.r import TRAFFIC_KEYS, k1_timing

__all__ = ["TRAFFIC_KEYS", "prepare", "warmup", "job", "k1_timing", "check"]

# the engine's minCamNum where config.txt leaves it out (TMVS default)
MIN_CAM_NUM = 3


def keep_seeds(ctx) -> None:
    """Wrap the program's feature seeding so that ``ctx.seeds`` gets each
    call's (centres, camera masks, image points); the run's ``restore``
    undoes it."""
    import torch
    from pais_mvs_tpu_torch import features
    orig = features.generate_seed_patches
    kept = ctx.seeds = []

    def call(*a, **k):
        with torch.profiler.record_function(trace.SPAN_PREFIX
                                            + "feature seeding"):
            out = orig(*a, **k)
        kept.append(tuple(np.array(x, copy=True) for x in out[:3]))
        return out

    ctx.patches.saved.append((features, "generate_seed_patches", orig))
    features.generate_seed_patches = call


def prepare(ctx):
    """``r.prepare`` (the scene, its files, the run's wrappers), and the
    seeds' wrapper."""
    r.prepare(ctx)
    keep_seeds(ctx)


def warmup(ctx):
    r.warmup(ctx)
    ctx.seeds.clear()


def job(ctx, index: int, profile: bool = False) -> r.Job:
    """``r.job``, with the seeds the job made (``seeds``: None for the
    profiled job, whose seeds are not judged)."""
    n = len(ctx.seeds)
    rec = r.job(ctx, index, profile)
    made = ctx.seeds[n:]
    del ctx.seeds[n:]
    rec["seeds"] = None if profile or not made else made[-1]
    return rec


def check(ctx, jobs) -> dict:
    """``r_many_views.check``'s readings of the clouds, and each job's
    seeds against the plain reference's: ``seed_gap`` and ``seed_px``
    (the widest over the jobs) in ``program``; with ``ctx.control``, the
    reference one precision step down (bfloat16 blur and descriptors)
    judged the same way in ``control``. Runs after the window, once the
    program's state is freed."""
    import torch
    from benchmark.reference import features as RF
    out = r_many_views.check(ctx, jobs)
    min_cams = int(ctx.cfg["config_txt"].get("minCamNum", MIN_CAM_NUM))
    cams = RF.cameras(ctx.scene.cameras)
    grays = RF.load_gray(ctx.scene_dir, ctx.scene.cameras)
    surf = ctx.scene.surface
    ref = RF.seeds(grays, cams, min_cams, ctx.device)
    judged = [RF.Seeds(*j["seeds"]) if j.get("seeds") is not None
              else None for j in jobs]
    gap = [RF.seed_gap(s, ref) if s is not None else np.nan
           for s in judged]
    px = [RF.seed_px(s, cams, surf) if s is not None else np.nan
          for s in judged]
    out.setdefault("program", {}).update(seed_gap=float(np.max(gap)),
                                         seed_px=float(np.max(px)))
    out["seeds"] = {"program": [None if s is None else len(s.masks)
                                for s in judged],
                    "reference": len(ref.masks),
                    "reference_seed_px": RF.seed_px(ref, cams, surf),
                    "seed_px_median": [None if s is None else RF.seed_px(
                        s, cams, surf, 0.5) for s in judged]}
    if ctx.control:
        ctl = RF.seeds(grays, cams, min_cams, ctx.device, torch.bfloat16)
        out.setdefault("control", {}).update(
            seed_gap=RF.seed_gap(ctl, ref), seed_px=RF.seed_px(ctl, cams,
                                                               surf))
        out["seeds"]["control"] = len(ctl.masks)
    del ref, grays
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out
