"""Batched patch lifecycle: everything ``Patch::refine`` does, as masked
tensor programs over a whole batch.

The PyTorch counterpart of ``pais_mvs_tpu/ops/lifecycle.py`` (single
device; the view-sharded ``view_axis`` paths come with the multi-GPU port).
The reference refines one patch at a time through a stateful method chain
(TMVS/mvs/patch.cpp:114-176): pick reference camera, derive depth/ray,
bound the depth search, pick a pyramid level, run PSO, drop invisible
cameras, repeat until the camera set stabilizes. Here each step is a
function over ``[B, ...]`` tensors; the stabilization loop becomes a fixed
number of re-optimization rounds with per-patch drop masks.

There is one fitness dispatcher: ``ops/cuda_fitness.py`` picks the kernel
or its plain twin by the device of the tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.models.patch import PatchBatch
from pais_mvs_tpu_torch.ops import cuda_fitness as CF
from pais_mvs_tpu_torch.ops import fitness as F
from pais_mvs_tpu_torch.ops import geometry as geom
from pais_mvs_tpu_torch.ops.pso import PsoDraws, gln_pso


def _project_all(rig, X, lod_scale=1.0):
    """Project X [B, 3] into every camera -> (xy [B, C, 2], z [B, C])."""
    return geom.project(X[:, None, :], rig.R, rig.T, rig.focal,
                        rig.principal, lod_scale)


# ---------------------------------------------------------------------------
# per-step primitives
# ---------------------------------------------------------------------------

def set_reference_camera(scene, normal, cam_mask):
    """argmax over visible cameras of normal . (-optical axis).
    Ref: Patch::setReferenceCameraIndex (patch.cpp:415-445)."""
    corr = -(normal[:, None, :] * scene.rig.optical).sum(-1)
    corr = torch.where(cam_mask, corr, -torch.inf)
    return torch.argmax(corr, dim=-1).to(torch.int32)


def set_depth_and_ray(scene, center, ref_cam):
    """Ref: Patch::setDepthAndRay (patch.cpp:447-461)."""
    ray = center - scene.rig.center[ref_cam]
    depth = torch.linalg.norm(ray, dim=-1)
    ray = ray / torch.where(depth > 0, depth, 1.0)[..., None]
    return depth, ray


def set_depth_range(scene, cfg: MvsConfig, center, ray, depth, ref_cam,
                    cam_mask, neighbor_radius):
    """Depth bounds from the 1-pixel-displacement sensitivity of the other
    views (patch.cpp:463-509). Views whose image displacement is < 0.01 px
    are skipped; a patch with no usable view is dropped.

    Returns (depth_range [B, 2], drop [B])."""
    rig = scene.rig
    C = rig.num_cameras
    c2 = ray * (depth + 1.0)[..., None] + rig.center[ref_cam]
    p1 = _project_all(rig, center)[0]
    p2 = _project_all(rig, c2)[0]
    img_dist = torch.linalg.norm(p1 - p2, dim=-1)             # [B, C]
    is_ref = torch.arange(C, device=center.device) == ref_cam[:, None]
    usable = cam_mask & ~is_ref & (img_dist >= 0.01)
    world_dist = 1.0 / torch.where(img_dist > 0, img_dist, 1.0)
    world_dist = torch.where(usable, world_dist, -torch.inf)
    max_wd = world_dist.max(dim=-1).values
    drop = ~usable.any(dim=-1)
    max_wd = torch.where(drop, 0.0, max_wd)
    lo = torch.clamp(depth - max_wd * cfg.depth_range_scalar, min=0.0)
    hi = depth + torch.minimum(max_wd * cfg.depth_range_scalar,
                               neighbor_radius * 100.0)
    return torch.stack([lo, hi], dim=-1), drop


def set_lod(scene, cfg: MvsConfig, center, ref_cam):
    """Climb the pyramid until the window's intensity variance reaches
    textureVariation (patch.cpp:511-610).

    Reference control flow per level l (starting at minLOD):
      * l >= camera maxLOD        -> use maxLOD, stop;
      * projection / window OOB   -> use max(l-1, 0), stop;
      * variance >= threshold     -> use l, stop;
      * else                      -> l+1.
    Vectorized: evaluate validity/variance at every level (L is small),
    then resolve the first stopping level per patch.
    """
    rig, pyrs = scene.rig, scene.pyramids
    B = center.shape[0]
    L = pyrs.num_levels
    dev = center.device
    sel = lambda a: a[ref_cam]
    valid, vars_ = [], []
    for l in range(L):
        # a Python float scale rounds to f32, as jnp.float32(...) does
        pt, z = geom.project(center, sel(rig.R), sel(rig.T), sel(rig.focal),
                             sel(rig.principal), cfg.lod_ratio ** l)
        dims = pyrs.dims[ref_cam, l].float()                  # [B, 2] (h, w)
        pin = ((pt[:, 0] >= 0) & (pt[:, 0] < dims[:, 1]) &
               (pt[:, 1] >= 0) & (pt[:, 1] < dims[:, 0]) & (z > 0) &
               torch.isfinite(pt).all(-1))
        lod_b = torch.full((B,), l, dtype=torch.int32, device=dev)
        # OOB projections feed NaN/huge coords into the gather's clip
        pt_s = torch.where(torch.isfinite(pt), pt, 0.0)
        var = F.nearest_gather(pyrs.var, pyrs.yoff, ref_cam, lod_b, pt_s)
        valid.append(pin & (var >= 0))
        vars_.append(var)
    valid = torch.stack(valid, dim=1)                         # [B, L]
    vars_ = torch.stack(vars_, dim=1)                         # bf16

    max_lod = rig.max_lod[ref_cam].long()                     # [B]
    lvl = torch.arange(L, device=dev)[None, :]
    at_cap = lvl >= max_lod[:, None]
    # compared in the atlas dtype, as JAX compares a bf16 array with a
    # Python float
    textured = vars_ >= torch.tensor(cfg.texture_variation, dtype=vars_.dtype)
    considered = lvl >= cfg.min_lod

    # first stopping level per patch
    stop_cap = at_cap & considered
    stop_oob = ~valid & ~at_cap & considered
    stop_tex = valid & textured & ~at_cap & considered
    any_stop = stop_cap | stop_oob | stop_tex
    first = torch.argmax(any_stop.to(torch.uint8), dim=1)     # [B]
    hit = torch.gather(any_stop, 1, first[:, None])[:, 0]
    first = torch.where(hit, first, max_lod)                  # exhausted -> cap
    oob_first = torch.gather(stop_oob, 1, first[:, None])[:, 0]
    lod = torch.where(oob_first, torch.clamp(first - 1, min=0),
                      torch.minimum(first, max_lod))
    return lod.to(torch.int32)


def remove_invisible_cameras(scene, cfg: MvsConfig, center, normal, ref_cam,
                             cam_mask, lod):
    """Ref: Patch::removeInvisibleCamera (patch.cpp:655-721).

    Returns (new_cam_mask, correlation, drop). ``correlation`` is computed
    over the PRE-removal camera set, as in the reference. The warped window
    vectors come from K2 (``cuda_fitness.warped_patch_vectors``)."""
    rig = scene.rig
    C = rig.num_cameras
    dev = center.device
    _, corr_table, correlation, ok = CF.warped_patch_vectors(
        scene, cfg, center, normal, ref_cam, cam_mask, lod)

    corr_sum = corr_table.sum(-1)                             # [B, C]
    corr_sum = torch.where(cam_mask, corr_sum, -torch.inf)
    # reference scans i = 0..camNum with >=, so ties pick the LAST index
    rev = torch.flip(corr_sum, dims=[1])
    max_idx = C - 1 - torch.argmax(rev, dim=-1)               # [B]

    H, _, pt = F.warp_geometry(scene, cfg, center, normal, ref_cam, lod)
    ratio = geom.homography_region_ratio(H, pt[:, None, :])   # [B, C]
    facing = -(normal[:, None, :] * rig.optical).sum(-1)      # [B, C]
    best_corr = torch.gather(
        corr_table, 1, max_idx[:, None, None].expand(-1, 1, C))[:, 0, :]
    is_best = torch.arange(C, device=dev) == max_idx[:, None]

    remove = ((ratio < cfg.min_region_ratio) | (facing < 0) |
              (~is_best & (best_corr < cfg.min_correlation)))
    new_mask = cam_mask & ~remove
    drop = (~ok) | (new_mask.sum(-1) < cfg.min_cam_num)
    return new_mask, correlation, drop


def set_priority(scene, fitness, correlation, cam_mask, lod):
    """priority = fitness * exp(-correlation - camNum/totalCams) * (LOD+1)
    (patch.cpp:612-625); lower is better."""
    total = scene.rig.num_cameras
    cam_ratio = cam_mask.sum(-1).to(fitness.dtype) / total
    return fitness * torch.exp(-correlation - cam_ratio) * \
        (lod.to(fitness.dtype) + 1.0)


def set_image_points_and_color(scene, center, ref_cam):
    """Level-0 projections into every camera + RGB color from the reference
    view (patch.cpp:627-653). Returns (img_point [B, C, 2], color [B, 3])."""
    pyrs = scene.pyramids
    ipts = _project_all(scene.rig, center)[0]                 # [B, C, 2]
    ref_pt = torch.gather(
        ipts, 1, ref_cam.long()[:, None, None].expand(-1, 1, 2))[:, 0, :]
    ref_pt = torch.where(torch.isfinite(ref_pt), ref_pt, 0.0)
    Hp, Wp = pyrs.rgb.shape[1:3]
    xi = torch.clamp(torch.round(ref_pt[:, 0]).to(torch.int32), 0, Wp - 1)
    yi = torch.clamp(torch.round(ref_pt[:, 1]).to(torch.int32), 0, Hp - 1)
    color = pyrs.rgb[ref_cam.long(), yi.long(), xi.long()].float()
    return ipts, color


def runtime_filter_static(scene, cfg: MvsConfig, pb: PatchBatch):
    """Device-side part of MVS::runtimeFiltering (mvs.cpp:838-875): drop,
    camera count, fitness/priority/correlation gates, NaNs, background or
    out-of-frame in ANY camera, front-facing camera count. The cell-map
    density clause (mvs.cpp:877-895) lives with the host cell grid.

    Returns keep [B] bool."""
    rig, pyrs = scene.rig, scene.pyramids
    B = pb.capacity
    C = rig.num_cameras
    keep = pb.valid
    keep = keep & (pb.cam_count() >= cfg.min_cam_num)
    keep = keep & (pb.fitness <= cfg.max_fitness)
    keep = keep & (pb.fitness != 0.0)
    keep = keep & (pb.priority <= 10000.0)
    keep = keep & (torch.isfinite(pb.fitness) & torch.isfinite(pb.priority)
                   & torch.isfinite(pb.correlation))
    keep = keep & (pb.correlation >= cfg.min_correlation)

    # center must project inside EVERY camera, onto non-background pixels
    xy, z = _project_all(rig, pb.center)                      # [B, C, 2], [B, C]
    dims = pyrs.dims[:, 0].float()                            # [C, 2]
    inside = ((xy[..., 0] >= 0) & (xy[..., 0] < dims[None, :, 1]) &
              (xy[..., 1] >= 0) & (xy[..., 1] < dims[None, :, 0]) &
              (z > 0) & torch.isfinite(xy).all(-1))
    xy_s = torch.where(torch.isfinite(xy), xy, 0.0)
    cam_b = torch.arange(C, dtype=torch.int32, device=xy.device).expand(B, C)
    lod0 = torch.zeros((B, C), dtype=torch.int32, device=xy.device)
    inten = F.nearest_gather(pyrs.images, pyrs.yoff, cam_b, lod0, xy_s)
    keep = keep & (inside & (inten != 0)).all(-1)

    facing = -(pb.normal()[:, None, :] * rig.optical).sum(-1)
    front = ((facing > 0) & pb.cam_mask).sum(-1)
    return keep & (front >= cfg.min_cam_num)


# ---------------------------------------------------------------------------
# the refine loop
# ---------------------------------------------------------------------------

class RefineResult(NamedTuple):
    batch: PatchBatch
    iterations: torch.Tensor    # [B] PSO iterations of the last round


def refine_batch(scene, cfg: MvsConfig, pb: PatchBatch, neighbor_radius,
                 is_seed: bool, rounds: int, final_filter: bool = True,
                 generator: torch.Generator | None = None,
                 draws: Sequence[PsoDraws] | None = None) -> RefineResult:
    """Batched Patch::refine (patch.cpp:114-176) + the follow-up
    removeInvisibleCamera its callers perform (mvs.cpp:215, 574).

    Seeds: full normal range, 2x particles & iterations, ``rounds``
    re-optimization rounds. Expansion: narrowed normal range
    (+-pi/reduceNormalRange), 1 round.

    ``final_filter=False`` skips the trailing MVS::runtimeFiltering gate
    (the reference applies it ONCE after the whole refine loop,
    mvs.cpp:217). Randomness: ``draws[rnd]`` (one ``PsoDraws`` per round)
    when given, else draws from ``generator``.
    """
    rig = scene.rig
    B = pb.capacity
    dev = pb.device
    neighbor_radius = torch.as_tensor(neighbor_radius, dtype=torch.float32,
                                      device=dev)

    valid = pb.valid & (pb.cam_count() >= cfg.min_cam_num)
    center = pb.center
    normal_sph = pb.normal_sph
    cam_mask = pb.cam_mask
    fitness = pb.fitness
    correlation = pb.correlation
    iters = torch.zeros(B, dtype=torch.int32, device=dev)

    particle_num = cfg.particle_num * (2 if is_seed else 1)
    max_iteration = cfg.max_iteration * (2 if is_seed else 1)
    # Python-float bounds round to f32 in each op, as the JAX package's
    # jnp.float32(pi / range) constants do
    span_p = math.pi / (2.0 if is_seed else cfg.reduce_normal_range)

    for rnd in range(rounds):
        normal = geom.spherical_to_normal(normal_sph)
        ref_cam = set_reference_camera(scene, normal, cam_mask)
        depth, ray = set_depth_and_ray(scene, center, ref_cam)
        depth_range, drop_dr = set_depth_range(
            scene, cfg, center, ray, depth, ref_cam, cam_mask, neighbor_radius)
        valid = valid & ~drop_dr
        lod = set_lod(scene, cfg, center, ref_cam)

        # PSO bounds (patch.cpp:183-200)
        if is_seed:
            lo_t = torch.zeros(B, device=dev)
            hi_t = torch.full((B,), math.pi, device=dev)
        else:
            lo_t = torch.clamp(normal_sph[:, 0] - span_p, min=0.0)
            hi_t = torch.clamp(normal_sph[:, 0] + span_p, max=math.pi)
        lo = torch.stack([lo_t, normal_sph[:, 1] - span_p, depth_range[:, 0]],
                         -1)
        hi = torch.stack([hi_t, normal_sph[:, 1] + span_p, depth_range[:, 1]],
                         -1)
        init = torch.stack([normal_sph[:, 0], normal_sph[:, 1], depth], -1)

        fit_fn = (lambda pos, act, ref_cam=ref_cam, lod=lod, ray=ray,
                  cam_mask=cam_mask: CF.patch_fitness(
                      scene, cfg, ref_cam, cam_mask, lod, ray, pos,
                      active=act))
        res = gln_pso(fit_fn, lo, hi, init,
                      particle_num=particle_num, max_iteration=max_iteration,
                      draws=None if draws is None else draws[rnd],
                      generator=generator, active0=valid,
                      exit_chunk=cfg.pso_exit_chunk)
        iters = res.iterations

        new_sph = res.gbest[:, :2]
        new_depth = res.gbest[:, 2]
        new_center = ray * new_depth[:, None] + rig.center[ref_cam]
        # only live patches move
        m1 = valid[:, None]
        normal_sph = torch.where(m1, new_sph, normal_sph)
        depth = torch.where(valid, new_depth, depth)
        center = torch.where(m1, new_center, center)
        fitness = torch.where(valid, res.gbest_fit, fitness)
        valid = valid & (fitness <= cfg.max_fitness)

        normal = geom.spherical_to_normal(normal_sph)
        new_mask, corr, drop_inv = remove_invisible_cameras(
            scene, cfg, center, normal, ref_cam, cam_mask, lod)
        cam_mask = torch.where(valid[:, None], new_mask, cam_mask)
        correlation = torch.where(valid, corr, correlation)
        valid = valid & ~drop_inv

    # final bookkeeping (patch.cpp:174-175) with the post-PSO camera set
    normal = geom.spherical_to_normal(normal_sph)
    ref_cam = set_reference_camera(scene, normal, cam_mask)
    depth, ray = set_depth_and_ray(scene, center, ref_cam)
    depth_range, drop_dr = set_depth_range(
        scene, cfg, center, ray, depth, ref_cam, cam_mask, neighbor_radius)
    valid = valid & ~drop_dr
    lod = set_lod(scene, cfg, center, ref_cam)
    priority = set_priority(scene, fitness, correlation, cam_mask, lod)
    img_point, color = set_image_points_and_color(scene, center, ref_cam)

    out = pb.replace(
        center=center, normal_sph=normal_sph, cam_mask=cam_mask,
        ref_cam=ref_cam, depth=depth, ray=ray, depth_range=depth_range,
        lod=lod, fitness=fitness, correlation=correlation, priority=priority,
        img_point=img_point,
        color=torch.where(valid[:, None], color, pb.color),
        valid=valid)
    if final_filter:
        out = out.replace(valid=runtime_filter_static(scene, cfg, out))
    return RefineResult(out, iters)


def apply_runtime_filter(scene, cfg: MvsConfig, pb: PatchBatch) -> PatchBatch:
    """Standalone MVS::runtimeFiltering gate (for host-driven round loops
    that defer it to the end, matching mvs.cpp:217)."""
    return pb.replace(valid=runtime_filter_static(scene, cfg, pb))


def rehydrate_batch(scene, cfg: MvsConfig, pb: PatchBatch,
                    neighbor_radius) -> PatchBatch:
    """Recompute all derived state from (center, spherical normal, camera
    set, fitness, correlation) — the reference's loader constructor
    (patch.cpp:45-59): refCam, depth/ray, depthRange, LOD, priority, image
    points, color."""
    valid = pb.valid & (pb.cam_count() >= cfg.min_cam_num)
    normal = geom.spherical_to_normal(pb.normal_sph)
    ref_cam = set_reference_camera(scene, normal, pb.cam_mask)
    depth, ray = set_depth_and_ray(scene, pb.center, ref_cam)
    depth_range, drop_dr = set_depth_range(
        scene, cfg, pb.center, ray, depth, ref_cam, pb.cam_mask,
        torch.as_tensor(neighbor_radius, dtype=torch.float32,
                        device=pb.device))
    valid = valid & ~drop_dr
    lod = set_lod(scene, cfg, pb.center, ref_cam)
    priority = set_priority(scene, pb.fitness, pb.correlation, pb.cam_mask,
                            lod)
    img_point, color = set_image_points_and_color(scene, pb.center, ref_cam)
    return pb.replace(ref_cam=ref_cam, depth=depth, ray=ray,
                      depth_range=depth_range, lod=lod, priority=priority,
                      img_point=img_point, color=color, valid=valid)


def prepare_seeds(scene, cfg: MvsConfig, pb: PatchBatch) -> PatchBatch:
    """Seed initialization after NVM load: re-triangulate from the measured
    image points and set the estimated normal (MVS::reCentering,
    mvs.cpp:135-145 + patch.cpp:67-112, 390-413)."""
    rig = scene.rig
    # unit rays through each measured pixel of every camera: [B, C, 3]
    dirs = geom.pixel_to_world_dir(pb.img_point, rig.R, rig.center,
                                   rig.focal, rig.principal)
    centers = geom.triangulate_rays(rig.center, dirs, pb.cam_mask)
    # keep original center if triangulation blew up
    ok = torch.isfinite(centers).all(-1)
    centers = torch.where(ok[:, None], centers, pb.center)

    normal = geom.estimated_normal(centers, rig.center[None], pb.cam_mask)
    sph = geom.normal_to_spherical(normal)
    valid = pb.valid & (pb.cam_count() >= cfg.min_cam_num)
    return pb.replace(center=centers, normal_sph=sph, valid=valid)
