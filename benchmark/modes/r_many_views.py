"""The ``-r`` job of ``r.py`` on a rig where a patch sees tens of cameras
out of hundreds: the same jobs, warm-up and K1 timing (imported), judged by
``reference/check_many_views.py``, the comparison with the admissible
states bounded to what a patch's last refine round can have held."""

from __future__ import annotations

import numpy as np

from benchmark.modes.r import (TRAFFIC_KEYS, job, k1_timing, prepare,
                               samples, warmup)
from benchmark.reference import mvsfile

__all__ = ["TRAFFIC_KEYS", "prepare", "warmup", "job", "k1_timing", "check"]

# the engine's visibleCorrelation, minCamNum and cellSize where config.txt
# leaves them out (the TMVS defaults, TMVS/TMVS.cpp:26-52)
VISIBLE_CORRELATION = 0.7
MIN_CAM_NUM = 3
CELL_SIZE = 4


def sample_clouds(clouds, sample_size: int, total: int) -> list:
    """The cloud each patch of ``samples(seed, clouds, total)`` (of
    ``sample_size`` patches) was drawn from: as many from each cloud as
    ``samples`` takes, in cloud order."""
    J = len(clouds)
    sizes = [min(total // J + (j < total % J), len(c.centers))
             for j, c in enumerate(clouds)]
    assert sum(sizes) == sample_size
    return [c for c, k in zip(clouds, sizes) for _ in range(k)]


def check(ctx, jobs) -> dict:
    """``r.check`` with ``check_many_views.readings``: the reference's
    readings of the jobs' clouds (``program``; with ``ctx.control`` also
    ``control``). Runs after the window, once the program's state is
    freed."""
    import torch
    from benchmark.reference.check_many_views import readings
    from benchmark.reference.photo import RefScene, engine_params
    params = engine_params(ctx.cfg["config_txt"])
    txt = ctx.cfg["config_txt"]
    cone = float(txt.get("visibleCorrelation", VISIBLE_CORRELATION))
    min_cams = int(txt.get("minCamNum", MIN_CAM_NUM))
    cell = float(txt.get("cellSize", CELL_SIZE))
    cams = ctx.scene.cameras
    clouds = [mvsfile.parse_cloud(j["cloud"]) for j in jobs]
    total = int(ctx.traffic["sampled_patches"])
    sample = samples(ctx.seed, clouds, total)
    drawn_from = sample_clouds(clouds, len(sample), total)
    surf = ctx.scene.surface
    dist = np.concatenate([surf.distance(c.centers) for c in clouds])
    ref = RefScene(ctx.scene_dir, cams, params, ctx.device)
    ctl = (RefScene(ctx.scene_dir, cams, params, ctx.device,
                    dtype=torch.bfloat16, quantize="fp8")
           if ctx.control else None)
    out = readings(ref, ctl, sample, surf, drawn_from, cone, min_cams,
                   cell)
    out["surface_dist_median"] = float(np.median(dist))
    out["cloud_patches"] = [j["patches"] for j in jobs]
    del ref, ctl
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out
