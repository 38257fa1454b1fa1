#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pais_mvs_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero on failure (nothing is caught):
  1. the card's name and power limit; the kernels' build from ``csrc/``;
  2. K1 (fused fitness) against its plain PyTorch twin at bench.py's
     selftest shape (256 patches x 16 particles, wide noise) on the
     synthetic bench scene and the real-photo pawn-rig scene, r in
     {3, 6, 15, 24}: exact BIG set, |err| <= 1e-4 (relative above 1);
  3. K2 (warped-window sampler) against its plain twin: same ok set, 1e-5;
  4. the main path: ``refine_batch`` in seed mode, one round, at the full
     bench.py workload (5 cameras at 640x480, r=15, 15 particles x 30
     iterations doubled for seeds, B=1024, maxLOD 6); the launch counts of
     that run (K1 = 61, K2 = 1), bench.py's quality bar (accepted > 50%,
     median surface distance < 0.003), and refined patches/s timed with
     CUDA events after a warm-up;
  5. the same slice on the card and on the CPU (plain twins) with the same
     PSO draws on a small batch: they must agree;
  6. bench.py's real-photo pawn-rig gate (2 rounds: accepted > 40%,
     median < 2.5e-3);
  7. the seed-stage ``Reconstructor`` end to end, writing a PLY and
     reading it back;
  8. each kernel's time at the main path's shapes beside its plain twin's,
     its roofline bound and, for K2, ``grid_sample`` on the same
     coordinates; printed as one ``{"kernels": [...]}`` line.
The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the package beside this script, it exits non-zero with no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# FP32 operations per (window pixel, visible camera) sample and per window
# pixel, counted from the kernels' arithmetic: homography 3 rows (6 mul +
# 6 add) + 2 divisions; fx/fy and 1-fx/1-fy (4); bilinear 8 mul + 3 add;
# mean 1 add; SAD sub + add (2) -> 32 per K1 sample (K2: the first 29).
# Per K1 pixel: window coordinates 2, mean/SAD divisions 2, difference
# weight 4 (mul, div, exp, mul), gradient weight 4 when enabled,
# foreground mask 1, sums 3.
K1_OPS_SAMPLE, K1_OPS_PIXEL, K1_OPS_GRAD = 32, 12, 4
K2_OPS_SAMPLE = 29


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def touched_atlas_elements(pyrs, H, pt, lod, cam_mask, keep, radius, lo,
                           hi_margin, rows=2048):
    """The distinct atlas elements the bilinear taps of a warp must read:
    only samples inside the margins, of visible cameras, of kept rows.
    H [N, C, 3, 3], pt [N, 2], lod [N], cam_mask [N, C], keep [N] bool.
    Returns a bool map over the flattened atlas (what the kernel must move
    from memory, whatever its padding and whatever the LOD bands hold)."""
    import torch
    from pais_mvs_tpu_torch.ops import fitness as F
    C, Ha, Wa = pyrs.images.shape
    touched = torch.zeros(C * Ha * Wa, dtype=torch.bool, device=pt.device)
    offs = torch.as_tensor(F.window_offsets(radius), device=pt.device)
    cam = torch.arange(C, device=pt.device)
    for s in range(0, pt.shape[0], rows):
        sl = slice(s, s + rows)
        win = pt[sl, None, :] + offs                          # [n, W2, 2]
        x, y = win[..., 0][..., None], win[..., 1][..., None]
        Hc = H[sl, None]                                      # [n,1,C,3,3]
        w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
        sw = torch.where(w == 0, 1.0, w)
        u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
        v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
        dims = pyrs.dims[cam, lod[sl, None].long()].float()   # [n, C, 2]
        hgt, wid = dims[:, None, :, 0], dims[:, None, :, 1]
        ok = ((u >= lo) & (u < wid - hi_margin) & (v >= lo)
              & (v < hgt - hi_margin) & (w != 0)
              & cam_mask[sl, None, :] & keep[sl, None, None])
        yo = pyrs.yoff[lod[sl].long()][:, None, None]
        # the kernels' clamps; the margins keep every kept tap in its band
        x0 = torch.floor(u).clamp(0, Wa - 2).long()
        y0 = (torch.floor(v).long() + yo).clamp(0, Ha - 2)
        i00 = (cam * (Ha * Wa) + y0 * Wa + x0)[ok]
        for d in (0, 1, Wa, Wa + 1):
            touched[i00 + d] = True
    return touched


def selftest_inputs(scene, cfg, pb, n, P, seed):
    """bench.py:135-145: n patches x P particles around their prepared
    state with deliberately wide noise (0.3, 0.3 rad; 0.002 depth)."""
    import torch
    from pais_mvs_tpu_torch.models import patch as pm
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    sub = pm.take(pb, np.arange(min(n, pb.capacity)))
    ref = lc.set_reference_camera(scene, sub.normal(), sub.cam_mask)
    depth, ray = lc.set_depth_and_ray(scene, sub.center, ref)
    lod = lc.set_lod(scene, cfg, sub.center, ref)
    noise = np.random.default_rng(seed).normal(size=(sub.capacity, P, 3)) \
        * np.array([0.3, 0.3, 0.002])
    pos = torch.stack([sub.normal_sph[:, 0], sub.normal_sph[:, 1], depth],
                      -1)[:, None, :] + torch.tensor(
                          noise, dtype=torch.float32, device=depth.device)
    return sub, ref, lod, ray, pos


def check_fitness(label, scene, cfg, ref, mask, lod, ray, pos, active=None):
    """K1 vs its plain twin on the same inputs; returns max |err|."""
    import torch
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import fitness as F
    H, pt, pvalid = F.fitness_geometry(scene, cfg, ref, mask, lod, ray, pos)
    args = (scene.pyramids, cfg, H, pt, ref, mask, lod, pvalid, active)
    plain = F.score_windows(*args)
    kern = CF.score_windows(*args)
    torch.cuda.synchronize()
    if active is not None:
        plain = torch.where(active[:, None], plain, 1e30)
    big_p, big_k = plain >= 1e20, kern >= 1e20
    if not torch.equal(big_p, big_k):
        fail(f"K1 {label}: BIG sets differ in {int((big_p != big_k).sum())} "
             f"of {big_p.numel()} candidates")
    ok = ~big_p
    err = (kern - plain).abs()[ok]
    lim = 1e-4 * torch.clamp(plain.abs()[ok], min=1.0)
    if not bool(torch.isfinite(kern[ok]).all()) or bool((err > lim).any()):
        fail(f"K1 {label}: max |err| {float(err.max()):.3g} over tolerance")
    m = float(err.max()) if err.numel() else 0.0
    log(f"K1 {label}: {int(ok.sum())}/{ok.numel()} scored, BIG set equal, "
        f"max |err| {m:.3g}")
    return m, (H, pt, pvalid)


def check_sampler(label, scene, cfg, center, normal, ref, mask, lod):
    """K2 vs its plain twin on the same inputs; returns max |err|."""
    import torch
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import fitness as F
    H, _, pt = F.warp_geometry(scene, cfg, center, normal, ref, lod)
    r = cfg.patch_radius
    plain = F.warped_samples(scene.pyramids, H, pt, lod, mask, r)
    kern = CF.warped_samples(scene.pyramids, H, pt, lod, mask, r)
    torch.cuda.synchronize()
    okp, okk = plain > F.INVALID / 2, kern > F.INVALID / 2
    if not torch.equal(okp, okk):
        fail(f"K2 {label}: ok sets differ in {int((okp != okk).sum())} "
             f"samples")
    err = (kern - plain).abs()[okp]
    m = float(err.max()) if err.numel() else 0.0
    if m > 1e-5 * max(1.0, float(plain[okp].abs().max())):
        fail(f"K2 {label}: max |err| {m:.3g} over tolerance")
    log(f"K2 {label}: {int(okp.sum())}/{okp.numel()} samples valid, ok set "
        f"equal, max |err| {m:.3g}")
    return m, (H, pt)


def main():
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA GPU", code=2)
    try:
        import pais_mvs_tpu_torch
    except ImportError as e:
        fail(f"the package pais_mvs_tpu_torch is not beside this script "
             f"({e})", code=2)
    if not os.path.abspath(pais_mvs_tpu_torch.__file__).startswith(
            os.path.join(HERE, "pais_mvs_tpu_torch")):
        fail("pais_mvs_tpu_torch was imported from outside this checkout: "
             f"{pais_mvs_tpu_torch.__file__}", code=2)
    from pais_mvs_tpu_torch.config import MvsConfig
    from pais_mvs_tpu_torch.data.realistic import make_realistic_scene
    from pais_mvs_tpu_torch.data.synthetic import make_scene
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    from pais_mvs_tpu_torch.io.pointcloud import read_ply
    from pais_mvs_tpu_torch.models import patch as pm
    from pais_mvs_tpu_torch.models.camera import build_scene
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import fitness as F
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    from pais_mvs_tpu_torch.ops.pso import draw_uniforms

    t_start = time.time()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 1. build every kernel of the path from csrc/ (parallel nvcc)
    t0 = time.time()
    logs = CF.build_kernels()
    log(f"kernel build: {time.time() - t0:.2f} s "
        f"({', '.join(sorted(logs)) or 'cached'})")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # the real-photo texture the pawn-rig scene needs
    from pais_mvs_tpu_torch.data import realistic
    if not os.path.exists(realistic.PHOTO_PATH):
        fail(f"the real-photo texture is missing: {realistic.PHOTO_PATH}")
    photo = realistic.load_photo()
    log(f"real-photo texture: {photo.shape} {photo.dtype}")

    # scenes: bench.py:92-110 and bench.py:171-183
    B = 1024
    cfg = MvsConfig(particle_num=15, max_iteration=30, dist_weighting=5.0,
                    batch_size=B, max_lod=6)
    t0 = time.time()
    sc = make_scene(num_cams=5, width=640, height=480, num_seeds=B + 64,
                    seed=0)
    scene = build_scene(sc.params, sc.images, cfg, device=dev)
    rsc = make_realistic_scene(num_seeds=128, seed=0)
    rcfg = MvsConfig(patch_radius=6, max_lod=4, particle_num=8,
                     max_iteration=12, dist_weighting=2.0, cell_size=12,
                     min_cam_num=3, batch_size=128)
    rscene = build_scene(rsc.params, rsc.images, rcfg, device=dev)
    log(f"scenes built: {time.time() - t0:.2f} s; atlas "
        f"{tuple(scene.pyramids.images.shape)} bf16")
    rng = np.random.default_rng(0)
    centers = sc.seed_centers[:B] + rng.normal(scale=0.01, size=(B, 3))
    pb = lc.prepare_seeds(scene, cfg, pm.from_seeds(
        centers, sc.seed_cam_masks[:B], sc.seed_img_points[:B], device=dev))
    Br = (len(rsc.seed_centers) // 8) * 8
    rpb = lc.prepare_seeds(rscene, rcfg, pm.from_seeds(
        rsc.seed_centers[:Br], rsc.seed_cam_masks[:Br],
        rsc.seed_img_points[:Br], device=dev))

    # 2. K1 vs plain at the selftest shape, both scenes, four radii
    err1 = 0.0
    for label, s, c, p in (("synthetic", scene, cfg, pb),
                           ("realistic", rscene, rcfg, rpb)):
        sub, ref, lod, ray, pos = selftest_inputs(s, c, p, 256, 16, 7)
        for r in (3, 6, 15, 24):
            cr = c.replace(patch_radius=r, dist_weighting=r / 3.0)
            err1 = max(err1, check_fitness(f"{label} r={r}", s, cr, ref,
                                           sub.cam_mask, lod, ray, pos)[0])
        act = torch.arange(sub.capacity, device=dev) % 3 != 0
        err1 = max(err1, check_fitness(f"{label} r={c.patch_radius} active",
                                       s, c, ref, sub.cam_mask, lod, ray,
                                       pos, act)[0])

    # 3. K2 vs plain: prepared seeds, on and off the surface
    err2 = 0.0
    for label, s, c, p in (("synthetic", scene, cfg, pb),
                           ("realistic", rscene, rcfg, rpb)):
        n = p.normal()
        ref = lc.set_reference_camera(s, n, p.cam_mask)
        lod = lc.set_lod(s, c, p.center, ref)
        for shift in (0.0, 0.02):
            err2 = max(err2, check_sampler(
                f"{label} shift={shift}", s, c, p.center + shift, n, ref,
                p.cam_mask, lod)[0])

    # 4. the main path: one seed round at the bench workload
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    CF.reset_launch_counts()
    t0 = time.time()
    res = lc.refine_batch(scene, cfg, pb, 0.005, True, 1, generator=gen)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = dict(CF.LAUNCHES)
    log(f"main path (refine_batch, seed mode, 1 round, B={B}): first run "
        f"{first_s:.2f} s, launches {launches}")
    if launches != {"fitness": 61, "sampler": 1}:
        fail(f"main path launch counts {launches}, expected fitness 61 "
             f"(1 + 2x30 PSO evaluations) and sampler 1")
    keep = res.batch.valid.cpu().numpy()
    d = sc.surface_distance(res.batch.center.cpu().numpy()[keep])
    med = float(np.median(d)) if keep.any() else float("inf")
    log(f"main path quality: accepted {int(keep.sum())}/{B}, median surface "
        f"distance {med:.6f}")
    if not (keep.sum() > 0.5 * B and med < 0.003):
        fail("main path misses bench.py's bar (accepted > 50%, median "
             "< 0.003)")
    if not bool(torch.isfinite(res.batch.center[res.batch.valid]).all()):
        fail("main path: non-finite centres among accepted patches")
    reps = 3
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    e0.record()
    for _ in range(reps):
        out = lc.refine_batch(scene, cfg, pb, 0.005, True, 1, generator=gen)
    e1.record()
    e1.synchronize()
    host_s = time.time() - t0
    round_ms = e0.elapsed_time(e1) / reps
    pps = B / (round_ms / 1e3)
    log(f"main path timed: {round_ms:.2f} ms per round (CUDA events, mean "
        f"of {reps} after warm-up), {pps:.1f} refined patches/s; host "
        f"clock {host_s / reps * 1e3:.2f} ms per round; accepted "
        f"{int(out.batch.valid.sum())}/{B}")

    # 5. the slice on the card vs on the CPU (plain twins), same draws
    Bs = 64
    small = pm.take(pb, np.arange(Bs))
    P, T = 2 * cfg.particle_num, 2 * cfg.max_iteration
    draws = draw_uniforms(Bs, P, 3, T,
                          generator=torch.Generator().manual_seed(5),
                          device="cpu")
    g = lc.refine_batch(scene, cfg, small, 0.005, True, 1,
                        draws=[type(draws)(*(t.to(dev) for t in draws))])
    c = lc.refine_batch(scene.to("cpu"), cfg, small.to("cpu"), 0.005, True,
                        1, draws=[draws])
    gv, cv = g.batch.valid.cpu().numpy(), c.batch.valid.numpy()
    bv = gv & cv
    dc = np.linalg.norm(g.batch.center.cpu().numpy()[bv]
                        - c.batch.center.numpy()[bv], axis=-1)
    agree = float((gv == cv).mean())
    mdc = float(np.median(dc)) if bv.any() else float("inf")
    log(f"card vs CPU slice (B={Bs}, same draws): valid agreement {agree:.3f}"
        f", accepted {int(gv.sum())} vs {int(cv.sum())}, median centre "
        f"difference {mdc:.3g}")
    if agree < 0.95 or abs(int(gv.sum()) - int(cv.sum())) > 2 or mdc > 1e-4:
        fail("the card's slice disagrees with the CPU reference")

    # 6. the real-photo pawn-rig gate (bench.py:184-191)
    rres = lc.refine_batch(rscene, rcfg, rpb, 0.01, True, 2,
                           generator=torch.Generator(device=dev)
                           .manual_seed(3))
    rkeep = rres.batch.valid.cpu().numpy()
    rd = rsc.surface_distance(rres.batch.center.cpu().numpy()[rkeep])
    rmed = float(np.median(rd)) if rkeep.any() else float("inf")
    log(f"realistic gate: {int(rkeep.sum())}/{Br} seeds, median surface "
        f"distance {rmed:.6f}")
    if not (rkeep.sum() > 0.4 * Br and rmed < 2.5e-3):
        fail("real-photo gate missed (accepted > 40%, median < 2.5e-3)")

    # 7. the seed-stage Reconstructor end to end, PLY out and back
    rec = Reconstructor(rsc.params, rsc.images,
                        rcfg.replace(seed_refine_rounds=2), verbose=False,
                        device="cuda")
    rec.load_seeds(rsc.seed_centers, rsc.seed_cam_masks,
                   rsc.seed_img_points)
    n = rec.refine_seeds()
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "seeds.ply")
        rec.write_ply(ply)
        pc, pn, _ = read_ply(ply)
    rmed2 = float(np.median(rsc.surface_distance(pc))) if n else float("inf")
    log(f"Reconstructor seed stage: {n}/{len(rsc.seed_centers)} seeds in "
        f"{rec.stats['seed_refine_s']:.2f} s ({rec.stats['seed_rounds']} "
        f"rounds), PLY {len(pc)} points, median surface distance "
        f"{rmed2:.6f}")
    if (n <= 0.4 * len(rsc.seed_centers) or len(pc) != n
            or not np.allclose(pc, rec.live_centers(), atol=1e-6)
            or not np.allclose(np.linalg.norm(pn, axis=-1), 1.0, atol=1e-5)
            or rmed2 >= 2.5e-3):
        fail("Reconstructor seed stage / PLY round trip")

    # 8. kernel times at the main path's shapes
    #    K1: the first PSO evaluation of the round (particles drawn in the
    #    PSO bounds, every live swarm active); the atlas stays in L2 across
    #    the PSO loop, as it does here across repeated launches
    normal = pb.normal()
    ref = lc.set_reference_camera(scene, normal, pb.cam_mask)
    depth, ray = lc.set_depth_and_ray(scene, pb.center, ref)
    dr, drop = lc.set_depth_range(scene, cfg, pb.center, ray, depth, ref,
                                  pb.cam_mask,
                                  torch.tensor(0.005, device=dev))
    valid = pb.valid & ~drop
    lod = lc.set_lod(scene, cfg, pb.center, ref)
    lo = torch.stack([torch.zeros(B, device=dev),
                      pb.normal_sph[:, 1] - np.pi / 2, dr[:, 0]], -1)
    hi = torch.stack([torch.full((B,), np.pi, device=dev),
                      pb.normal_sph[:, 1] + np.pi / 2, dr[:, 1]], -1)
    u = torch.rand((B, P, 3), generator=gen, device=dev)
    pos = lo[:, None] + (hi - lo)[:, None] * u
    err_main, (H, pt, pvalid) = check_fitness(
        f"main shape B={B} P={P}", scene, cfg, ref, pb.cam_mask, lod, ray,
        pos, valid)
    err1 = max(err1, err_main)
    k1 = (scene.pyramids, cfg, H, pt, ref, pb.cam_mask, lod, pvalid, valid)
    k1_ms = time_ms(lambda: CF.score_windows(*k1), reps=20)
    k1_plain = time_ms(lambda: F.score_windows(*k1), reps=3, warmup=1)
    W2 = (2 * cfg.patch_radius + 1) ** 2
    C = scene.num_cameras
    live = (pvalid & valid[:, None]).sum(1)                    # [B]
    ncam = pb.cam_mask.sum(1)
    k1_ops = float((live * W2 * (ncam * K1_OPS_SAMPLE + K1_OPS_PIXEL
                                 + (K1_OPS_GRAD if
                                    cfg.adaptive_gradient_enable else 0))
                    ).sum())
    #    bytes: the atlas elements the kept particles' taps read (bilinear
    #    taps inside K1's margins, plus the nearest reference pixel of every
    #    window pixel in images and, with the gradient weight, in edges),
    #    H and pt of the kept particles, the small inputs whole, the output
    atlas = scene.pyramids.images
    kept = (pvalid & valid[:, None]).reshape(-1)
    img_t = touched_atlas_elements(
        scene.pyramids, H.reshape(B * P, C, 3, 3), pt.reshape(B * P, 2),
        lod.repeat_interleave(P), pb.cam_mask.repeat_interleave(P, 0), kept,
        cfg.patch_radius, 2.0, 3.0)
    offs = torch.as_tensor(F.window_offsets(cfg.patch_radius), device=dev)
    win = pt.reshape(B * P, 1, 2)[kept] + offs                 # [n, W2, 2]
    Ha, Wa = atlas.shape[1:]
    lk = lod.repeat_interleave(P)[kept].long()[:, None]
    xi = torch.round(win[..., 0]).to(torch.int32).clamp(0, Wa - 1).long()
    yi = (torch.round(win[..., 1]).to(torch.int32).long()
          + scene.pyramids.yoff[lk]).clamp(0, Ha - 1)
    ridx = (ref.repeat_interleave(P)[kept].long()[:, None] * (Ha * Wa)
            + yi * Wa + xi).reshape(-1)
    ref_t = torch.zeros_like(img_t)
    ref_t[ridx] = True
    n_img = int((img_t | ref_t).sum())
    n_edge = int(ref_t.sum()) if cfg.adaptive_gradient_enable else 0
    n_kept = int(kept.sum())
    k1_bytes = float((n_img + n_edge) * atlas.element_size()
                     + n_kept * (C * 9 + 2) * 4 + pvalid.numel()
                     + ref.numel() * 4 + lod.numel() * 4
                     + pb.cam_mask.numel() + valid.numel() + W2 * 4
                     + B * P * 4)
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_OPS_PER_S) * 1e3
    k1_by = ("bytes" if k1_bytes / HBM_BYTES_PER_S
             >= k1_ops / FP32_OPS_PER_S else "operations")
    log(f"K1 at B={B} P={P} r={cfg.patch_radius}: {k1_ms:.4f} ms/launch, "
        f"plain {k1_plain:.3f} ms, bound {k1_bound:.4f} ms ({k1_by}: "
        f"{k1_ops:.3e} FP32 ops, {k1_bytes:.3e} bytes of which atlas "
        f"{n_img} image + {n_edge} edge elements of {atlas.numel()}, "
        f"{n_kept} of {B * P} particles kept); x61 per round = "
        f"{61 * k1_ms:.2f} ms of the {round_ms:.2f} ms round")

    #    K2: the round's NCC pruning call, on the round's output patches
    ob = res.batch
    err_main2, (H2, pt2) = check_sampler(
        f"main shape B={B}", scene, cfg, ob.center, ob.normal(), ob.ref_cam,
        ob.cam_mask, ob.lod)
    err2 = max(err2, err_main2)
    r = cfg.patch_radius
    k2 = (scene.pyramids, H2, pt2, ob.lod, ob.cam_mask, r)
    k2_ms = time_ms(lambda: CF.warped_samples(*k2), reps=50)
    k2_plain = time_ms(lambda: F.warped_samples(*k2), reps=5, warmup=1)
    k2_ops = float(int(ob.cam_mask.sum()) * W2 * K2_OPS_SAMPLE)
    #    bytes: the distinct atlas elements the in-margin taps read, the
    #    small inputs whole, the [B, C, W2] f32 output written once
    n_k2 = int(touched_atlas_elements(
        scene.pyramids, H2, pt2, ob.lod, ob.cam_mask,
        torch.ones(B, dtype=torch.bool, device=dev), r, 0.0, 1.0).sum())
    k2_bytes = float(n_k2 * atlas.element_size() + H2.numel() * 4
                     + pt2.numel() * 4 + B * 4 + ob.cam_mask.numel()
                     + B * C * W2 * 4)
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / FP32_OPS_PER_S) * 1e3
    k2_by = ("bytes" if k2_bytes / HBM_BYTES_PER_S
             >= k2_ops / FP32_OPS_PER_S else "operations")
    #    library yardstick: grid_sample on the same coordinates (the atlas
    #    as [C, 1, Ha, Wa] f32, one grid row per camera)
    import torch.nn.functional as TNF
    offs = torch.as_tensor(F.window_offsets(r), device=dev)
    win = pt2[:, None, :] + offs                               # [B, W2, 2]
    x, y = win[..., 0][..., None], win[..., 1][..., None]
    Hc = H2[:, None]                                           # [B,1,C,3,3]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = torch.where(w == 0, 1.0, w)
    uu = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    vv = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    vv = vv + scene.pyramids.yoff[ob.lod.long()].float()[:, None, None]
    grid = torch.stack([uu / (Wa - 1) * 2 - 1, vv / (Ha - 1) * 2 - 1],
                       -1).permute(2, 0, 1, 3).contiguous()   # [C,B,W2,2]
    img = atlas.float()[:, None]
    lib_ms = time_ms(lambda: TNF.grid_sample(
        img, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), reps=50)
    log(f"K2 at B={B} r={r}: {k2_ms:.4f} ms/launch, plain {k2_plain:.3f} ms"
        f", grid_sample {lib_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_by}: "
        f"{k2_bytes:.3e} bytes of which atlas {n_k2} elements of "
        f"{atlas.numel()}, {k2_ops:.3e} FP32 ops)")
    torch.cuda.synchronize()

    kernels = [
        {"name": "fused_fitness", "route": "cuda",
         "source": "pais_mvs_tpu_torch/csrc/fitness.cu",
         "replaces": "pais_mvs_tpu/ops/pallas_fitness.py:552",
         "launches": launches["fitness"], "max_abs_err": err1,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "warped_sampler", "route": "cuda",
         "source": "pais_mvs_tpu_torch/csrc/sampler.cu",
         "replaces": "pais_mvs_tpu/ops/pallas_fitness.py:67",
         "launches": launches["sampler"], "max_abs_err": err2,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": lib_ms},
    ]
    log(f"total {time.time() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
