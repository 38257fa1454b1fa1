"""Command-line entry point of the port, mirroring the reference TMVS modes
(TMVS/TMVS.cpp:174-203) as ``pais_mvs_tpu/cli.py`` does:

  python -m pais_mvs_tpu_torch.cli -r scene.nvm[.nvm2|.mvs]   reconstruction
  python -m pais_mvs_tpu_torch.cli -f scene.mvs               post-filtering
  python -m pais_mvs_tpu_torch.cli -v scene.mvs               snapshot "viewer"
  python -m pais_mvs_tpu_torch.cli -a scene.mvs               insertion-order replay

``-r`` on an NVM without sparse points seeds by feature matching; ``-b``
bundle-adjusts the poses over the NVM's tracks first; ``-v --patch-id N``
saves the patch's warped windows and SAD heat-map, ``--reoptimize`` refines
it once more; ``--profile DIR`` writes a ``torch.profiler`` trace.

``--distributed-expansion`` runs the expansion as SPMD cell-slab rounds
(``Reconstructor.expand_distributed``). Several processes join through
``--coordinator host:port --num-processes N --process-id I`` (one per
card with NCCL, or gloo when they share a card or run on the CPU); every
process runs the same program and writes its artifacts under its own
``-o``. ``--mesh-shape dp,vp`` lays the processes out as dp patch ranks
by vp view ranks (camera-block atlases; vp must divide the camera count,
dp*vp must equal the process count); without it every process is a patch
rank, and a single process expands in a world of one. The mesh is checked
right after the cameras load, before any refine; with dp > 1 the seed
refine runs data-parallel too (``dataParallel auto`` on a card, ``on``).

It runs on the GPU (``--device cuda``, the default) and raises without one;
``--device cpu`` runs the plain PyTorch versions of the kernels. Config
resolution matches the reference: compiled defaults (TMVS.cpp:26-52)
overridden by ./config.txt if present (TMVS.cpp:178), re-applied after an
.mvs load (TMVS.cpp:92). Staged artifacts (init/seed/exp.mvs, exp.ply,
exp.psr, PMVS/PCMVS filter dumps, stats.json, log.txt) keep the
reference's names, and ``-r auto_save.mvs`` resumes from the autosave
checkpoint (its ``.state.npz`` sidecar carries the expansion frontier).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch.distributed as dist

from pais_mvs_tpu_torch import resolve_device
from pais_mvs_tpu_torch.config import MvsConfig, load_config_txt
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
from pais_mvs_tpu_torch.io import mvsbin
from pais_mvs_tpu_torch.io import nvm as nvm_io
from pais_mvs_tpu_torch.io.logmanager import LogManager
from pais_mvs_tpu_torch.io.pointcloud import write_ply
from pais_mvs_tpu_torch.models import patch as patch_mod
from pais_mvs_tpu_torch.parallel.distributed import init_from_flags
from pais_mvs_tpu_torch.parallel.mesh import make_mesh

CONFIG_FILE_NAME = "config.txt"


def _parse_mesh_shape(text: str | None):
    """``--mesh-shape dp,vp`` as a pair of positive ints (None when not
    given); anything else stops with a SystemExit."""
    if text is None:
        return None
    parts = text.split(",")
    if len(parts) != 2 or not all(p.strip().isdigit() and int(p) > 0
                                  for p in parts):
        raise SystemExit(f"--mesh-shape must be dp,vp (two positive "
                         f"integers), got {text!r}")
    return tuple(int(p) for p in parts)


def _mesh_for(shape, num_cams: int):
    """This process's (dp, vp) mesh over the started world, or None for
    a single process (the expansion then makes a world of one). Stops
    with a SystemExit when vp does not divide the camera count or dp*vp
    is not the process count."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        return make_mesh() if world > 1 else None
    dp, vp = shape
    if num_cams % vp:
        raise SystemExit(f"--mesh-shape view axis {vp} must divide the "
                         f"camera count {num_cams}")
    if dp * vp != world:
        raise SystemExit(f"--mesh-shape {dp},{vp} needs {dp * vp} "
                         f"processes, the run has {world} (start them with "
                         f"--coordinator, --num-processes and --process-id)")
    return make_mesh(shape) if world > 1 else None


def _load_images(params, base_dir):
    from PIL import Image
    images = []
    for p in params:
        path = p.file_name
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        images.append(np.asarray(Image.open(path).convert("RGB")))
    return images


def _resolve_config(base: MvsConfig | None = None) -> MvsConfig:
    cfg = base or MvsConfig()
    if os.path.exists(CONFIG_FILE_NAME):
        cfg = load_config_txt(CONFIG_FILE_NAME, cfg)
    return cfg


def _cam_principal(cam, img) -> np.ndarray:
    """Principal point with the reference's image-center fallback for
    unset (-1, -1) NVM principals."""
    if cam.principal[0] < 0 and cam.principal[1] < 0:
        return np.array([img.shape[1] >> 1, img.shape[0] >> 1], float)
    return np.asarray(cam.principal, float)


def _pinhole_points(cameras, images, ipts: np.ndarray,
                    cfg: MvsConfig) -> np.ndarray:
    """Undistort per-camera pixel measurements when applyDistortion is set
    (the engine runs pure pinhole; build_scene undistorts the images)."""
    if not cfg.apply_distortion:
        return ipts
    from pais_mvs_tpu_torch.models.camera import undistort_points
    ipts = np.array(ipts, dtype=float, copy=True)
    for ci, (cam, img) in enumerate(zip(cameras, images)):
        if abs(float(cam.radial_distortion)) < 1e-12:
            continue
        ipts[:, ci] = undistort_points(
            ipts[:, ci], cam.focal, _cam_principal(cam, img),
            float(cam.radial_distortion))
    return ipts


def _pinhole_images(cameras, images, cfg: MvsConfig):
    """Undistorted copies of the input images when applyDistortion is set
    (for host-side consumers like feature seeding that must see the same
    pinhole imagery the engine samples)."""
    if not cfg.apply_distortion:
        return images
    from pais_mvs_tpu_torch.models.camera import undistort_image
    return [undistort_image(img, cam.focal, _cam_principal(cam, img),
                            float(cam.radial_distortion))
            if abs(float(cam.radial_distortion)) >= 1e-12 else img
            for cam, img in zip(cameras, images)]


def _refine_poses(params, images, centers, cam_masks, img_points, device):
    """Pose-refinement bundle adjustment over the SfM tracks before dense
    reconstruction (new scope vs the reference, which trusts VisualSFM
    poses as-is), on ``device``. Updates ``params`` in place and returns
    the refined track centres."""
    import torch
    from pais_mvs_tpu_torch.data.synthetic import rotation_to_quaternion
    from pais_mvs_tpu_torch.models.camera import _np_quat_to_rotation
    from pais_mvs_tpu_torch.ops.bundle import BaProblem, bundle_adjust

    Rs, cs, fs, pps = [], [], [], []
    for i, p in enumerate(params):
        Rs.append(_np_quat_to_rotation(np.asarray(p.quaternion, float)))
        cs.append(np.asarray(p.center, float))
        fs.append(np.asarray(p.focal, float))
        pps.append(_cam_principal(p, images[i]))
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                    device=device)
    prob = BaProblem(
        R=f32(np.stack(Rs)), center=f32(np.stack(cs)),
        focal=f32(np.stack(fs)), principal=f32(np.stack(pps)),
        points=f32(centers), obs=f32(img_points),
        mask=torch.as_tensor(np.asarray(cam_masks, dtype=bool),
                             device=device))
    res = bundle_adjust(prob, num_iters=8)
    h = res.rms_history.cpu().numpy()
    print(f"pose refinement: reprojection RMS {h[0]:.3f} -> {h[-1]:.3f} px")
    Rn = res.R.cpu().numpy().astype(float)
    cn = res.center.cpu().numpy().astype(float)
    for i, p in enumerate(params):
        p.quaternion = rotation_to_quaternion(Rn[i])
        p.center = cn[i]
    return res.points.cpu().numpy().astype(float)


def _build_reconstructor(path: str, out_dir: str, device,
                         refine_poses: bool = False,
                         mesh_shape=None) -> Reconstructor:
    ext = path.rsplit(".", 1)[-1].lower()
    base_dir = os.path.dirname(os.path.abspath(path))
    logger = LogManager(os.path.join(out_dir, "log.txt"))
    if ext in ("nvm", "nvm2"):
        data = nvm_io.load_nvm(path, nvm2=(ext == "nvm2"))
        mesh = _mesh_for(mesh_shape, len(data.cameras))
        cfg = _resolve_config()
        images = _load_images(data.cameras, base_dir)
        ipts = None
        if len(data.centers):
            ipts = nvm_io.decenter_image_points(
                data, [img.shape[1] for img in images],
                [img.shape[0] for img in images])
            # the engine (and bundle adjustment) is pure pinhole:
            # measurements from a distorted NVM are undistorted first
            ipts = _pinhole_points(data.cameras, images, ipts, cfg)
            if refine_poses:
                data.centers = _refine_poses(data.cameras, images,
                                             data.centers, data.cam_masks,
                                             ipts, device)
        elif refine_poses:
            logger.warning("--refine-poses ignored: the NVM has no sparse "
                           "tracks to bundle-adjust over")
        rec = Reconstructor(data.cameras, images, cfg, logger=logger,
                            device=device, mesh=mesh)
        if ipts is not None:
            rec.load_seeds(data.centers, data.cam_masks, ipts, data.colors)
        else:
            # no sparse points in the NVM: feature-match our own seeds
            # (reference FeatureManager fallback, TMVS.cpp:98-103,
            # epipolar tolerance 3.0 px) on the SAME pinhole imagery the
            # engine samples
            from pais_mvs_tpu_torch.features import generate_seed_patches
            centers, cam_masks, s_ipts, colors = generate_seed_patches(
                data.cameras, _pinhole_images(data.cameras, images, cfg),
                cfg, max_epipolar_dist=3.0, device=device)
            rec._log(f"feature seeding: {len(centers)} seeds")
            if len(centers):
                rec.load_seeds(centers, cam_masks, s_ipts, colors)
    elif ext == "mvs":
        if refine_poses:
            logger.warning("--refine-poses ignored: .mvs checkpoints carry "
                           "no track measurements to bundle-adjust over")
        f = mvsbin.read_mvs(path)
        mesh = _mesh_for(mesh_shape, len(f.cameras))
        cfg = _resolve_config(f.config)
        images = _load_images(f.cameras, base_dir)
        rec = Reconstructor(f.cameras, images, cfg, logger=logger,
                            device=device, mesh=mesh)
        # a .state.npz sidecar (written by autosave) restores the full
        # arena incl. the expansion frontier; otherwise treat the .mvs
        # patches as seeds to re-refine (reference -r .mvs semantics)
        if rec.load_checkpoint(path):
            rec.resumed = True
        elif len(f.patches.centers):
            rec.load_seeds_from_mvs(f.patches)
    else:
        raise SystemExit(f"unsupported input: {path}")
    return rec


def _dump_stats(rec: Reconstructor, out_dir: str) -> None:
    stats = dict(rec.stats)
    stats["live_patches"] = int(len(rec.arena.live_ids()))
    stats["total_patches"] = int(rec.arena.count)
    stats["deleted_patches"] = int(len(rec.arena.deleted_ids))
    stats["neighbor_radius"] = float(rec.neighbor_radius)
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)


def run_reconstruct(path: str, out_dir: str = ".",
                    refine_poses: bool = False,
                    live_snapshots: bool = False, device="cuda",
                    distributed: bool = False, mesh_shape=None) -> None:
    rec = _build_reconstructor(path, out_dir, device,
                               refine_poses=refine_poses,
                               mesh_shape=mesh_shape)
    if live_snapshots:
        rec.live_snapshot_dir = out_dir
    rec._log(rec.cfg.describe())
    j = lambda n: os.path.join(out_dir, n)
    t0 = time.time()
    if not rec.resumed:
        rec.write_mvs(j("init.mvs"))
        rec.refine_seeds()
        rec.write_mvs(j("seed.mvs"))
    # a resumed checkpoint continues expansion where it stopped
    if distributed:
        rec.expand_distributed(autosave_path=j("auto_save.mvs"))
    else:
        rec.expand(autosave_path=j("auto_save.mvs"))
    rec.write_mvs(j("exp.mvs"))
    rec.write_ply(j("exp.ply"))
    rec.write_psr(j("exp.psr"))
    _dump_stats(rec, out_dir)
    print(f"time1\t{time.time() - t0:f}")


def run_filter(path: str, out_dir: str = ".", device="cuda") -> None:
    if not path.endswith(".mvs"):
        print("filtering only mvs file")
        return
    rec = _build_reconstructor(path, out_dir, device)
    rec._log(rec.cfg.describe())
    if not rec.resumed:
        rec.adopt_loaded_patches()
    j = lambda n: os.path.join(out_dir, n)
    t0 = time.time()
    rec.cell_filtering()
    rec.write_mvs(j("PMVS_filter1.mvs")); rec.write_ply(j("PMVS_filter1.ply"))
    rec.visibility_filtering()
    rec.write_mvs(j("PMVS_filter2.mvs")); rec.write_ply(j("PMVS_filter2.ply"))
    rec.neighbor_cell_filtering(0.25)
    rec.write_mvs(j("PMVS_filter3.mvs")); rec.write_ply(j("PMVS_filter3.ply"))
    rec.write_mvs(j("PMVS_filter_deleted.mvs"), deleted=True)
    rec.write_ply(j("PMVS_filter_deleted.ply"), deleted=True)
    rec.arena.deleted_ids.clear()
    rec.neighbor_patch_filtering(0.25)
    rec.write_mvs(j("PCMVS_filter.mvs")); rec.write_ply(j("PCMVS_filter.ply"))
    rec.write_mvs(j("PCMVS_filter_deleted.mvs"), deleted=True)
    rec.write_ply(j("PCMVS_filter_deleted.ply"), deleted=True)
    _dump_stats(rec, out_dir)
    print(f"time1\t{time.time() - t0:f}")


def _normals(p) -> np.ndarray:
    st = np.sin(p.normal_sph[:, 0])
    return np.stack([st * np.cos(p.normal_sph[:, 1]),
                     st * np.sin(p.normal_sph[:, 1]),
                     np.cos(p.normal_sph[:, 0])], -1)


def run_view(path: str, out_dir: str = ".",
             patch_id: int | None = None,
             reoptimize: bool = False, device="cuda") -> None:
    """Offline replacement for the PCL viewer: dump a PLY snapshot, stats
    and a self-contained HTML viewer. With ``patch_id``, additionally save
    the picked patch's warped-window mosaic + SAD heat-map (the viewer's
    point-pick diagnostics, view/mvsviewer.cpp:441-471), sampled on
    ``device``; ``reoptimize`` refines that patch once more (the viewer's
    Shift+S, view/mvsviewer.cpp:56-71) and saves the 'after' mosaics."""
    from pais_mvs_tpu_torch.diagnostics import (save_patch_diagnostics,
                                                write_html_viewer)
    from pais_mvs_tpu_torch.models.camera import _np_quat_to_rotation
    f = mvsbin.read_mvs(path)
    p = f.patches
    normals = _normals(p)
    out = os.path.join(out_dir, "view_snapshot.ply")
    write_ply(out, p.centers, normals, np.full((len(p.centers), 3), 200.0))
    print(f"cameras: {len(f.cameras)}  patches: {len(p.centers)}")
    print(f"fitness: mean {p.fitness.mean():.4f}  "
          f"correlation: mean {p.correlation.mean():.4f}")
    print(f"wrote {out}")

    html = os.path.join(out_dir, "view.html")
    cam_c = np.array([np.asarray(c.center, float) for c in f.cameras])
    cam_ax = np.array([
        _np_quat_to_rotation(np.asarray(c.quaternion, float)).T
        @ np.array([0.0, 0.0, 1.0]) for c in f.cameras])
    write_html_viewer(html, p.centers,
                      np.full((len(p.centers), 3), 200.0),
                      normals=normals, ids=np.arange(len(p.centers)),
                      cam_centers=cam_c, cam_axes=cam_ax,
                      cam_names=[c.file_name for c in f.cameras])
    print(f"wrote {html} (interactive: orbit/zoom, 'c' color, 'o' replay,"
          f" 'n' normals, 'v' cameras, click = patch readout)")
    if patch_id is None:
        return

    i = int(patch_id)
    if not 0 <= i < len(p.centers):
        raise SystemExit(f"patch id {i} out of range")
    base_dir = os.path.dirname(os.path.abspath(path))
    cfg = _resolve_config(f.config)
    images = _load_images(f.cameras, base_dir)
    rec = Reconstructor(f.cameras, images, cfg, verbose=False,
                        device=device)
    rec.load_seeds_from_mvs(p)
    pb = rec._seed_pb
    one = patch_mod.take(pb, [i]).numpy()
    save_patch_diagnostics(
        rec.scene, cfg, one["center"][0], one["normal_sph"][0],
        int(one["ref_cam"][0]), one["cam_mask"][0], int(one["lod"][0]),
        out_dir, i, fitness=float(p.fitness[i]))
    if not reoptimize:
        return

    # Recover the volume-derived neighborRadius from the loaded cloud (the
    # .mvs does not embed it) so the depth-search bounds match the
    # original reconstruction's.
    import torch
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    ext = p.centers.max(0) - p.centers.min(0)
    vol = float(abs(ext[0] * ext[1] * ext[2]))
    if vol > 0:
        rec.neighbor_radius = vol ** (1.0 / 3.0) * cfg.neighbor_radius_scalar
    gen = torch.Generator(rec.device).manual_seed(cfg.rng_seed)
    res = lc.refine_batch(rec.scene, cfg, patch_mod.take(pb, [i]),
                          rec.neighbor_radius, True, 1, generator=gen)
    nb = res.batch.numpy()
    print(f"re-optimized: fitness {float(p.fitness[i]):.6f} -> "
          f"{float(nb['fitness'][0]):.6f}, "
          f"center {one['center'][0]} -> {nb['center'][0]}, "
          f"valid={bool(nb['valid'][0])}")
    save_patch_diagnostics(
        rec.scene, cfg, nb["center"][0], nb["normal_sph"][0],
        int(nb["ref_cam"][0]), nb["cam_mask"][0], int(nb["lod"][0]),
        out_dir, i * 1000000 + 1, fitness=float(nb["fitness"][0]))


def run_animate(path: str, out_dir: str = ".") -> None:
    """Insertion-order replay export (the reference's -a animate mode,
    TMVS.cpp:66-74 / view/mvsviewer.cpp:258-265): a PLY with a per-point
    ``order`` scalar — color by it to watch the reconstruction grow."""
    from pais_mvs_tpu_torch.diagnostics import write_animate_ply
    p = mvsbin.read_mvs(path).patches
    out = os.path.join(out_dir, "animate.ply")
    write_animate_ply(out, p.centers, _normals(p),
                      np.full((len(p.centers), 3), 200.0))
    print(f"wrote {out} ({len(p.centers)} patches in insertion order)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pais-mvs-tpu-torch",
        description="patch-based multi-view stereo on one NVIDIA GPU "
                    "(the PyTorch/CUDA port)")
    ap.add_argument("-r", metavar="FILE", help="reconstruct (.nvm/.nvm2/.mvs)")
    ap.add_argument("-f", metavar="FILE", help="post-filter (.mvs)")
    ap.add_argument("-v", metavar="FILE", help="snapshot view (.mvs)")
    ap.add_argument("-a", metavar="FILE",
                    help="animate: insertion-order replay PLY (.mvs)")
    ap.add_argument("-o", "--out-dir", default=".", help="output directory")
    ap.add_argument("-b", "--refine-poses", action="store_true",
                    help="bundle-adjust camera poses over the SfM tracks "
                         "before dense reconstruction")
    ap.add_argument("--mesh-shape", default=None,
                    help="dp,vp layout of the processes: patch ranks x view "
                         "ranks (camera-block atlases; dp*vp must equal "
                         "the process count and vp must divide the camera "
                         "count). Default: every process a patch rank")
    ap.add_argument("--distributed-expansion", action="store_true",
                    help="run the expansion as SPMD cell-slab rounds over "
                         "the processes (a world of one without "
                         "--coordinator)")
    ap.add_argument("--live-snapshots", action="store_true",
                    help="refresh OUT_DIR/live_snapshot.ply at every "
                         "autosave so the growing cloud can be watched "
                         "mid-run (the reference's addPatchView hook)")
    ap.add_argument("--patch-id", type=int, default=None,
                    help="with -v: dump the patch's warped-window mosaic "
                         "and SAD heat-map PNGs")
    ap.add_argument("--reoptimize", action="store_true",
                    help="with -v --patch-id: re-run the optimizer on that "
                         "patch and report before/after (viewer Shift+S)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace (CPU and, on the "
                         "GPU, CUDA activity) of the run into DIR as a "
                         "Chrome trace file")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process: rendezvous address host:port "
                         "(process 0 listens there)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="multi-process: total process count")
    ap.add_argument("--process-id", type=int, default=None,
                    help="multi-process: this process's id, 0..N-1")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)."
                         " 'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)

    mesh_shape = _parse_mesh_shape(args.mesh_shape)
    if not (args.r or args.f or args.v or args.a):
        ap.print_help()
        return 1
    device = resolve_device(args.device)
    started = init_from_flags(args.coordinator, args.num_processes,
                              args.process_id, device) is not None
    try:
        return _run_mode(args, device, mesh_shape)
    finally:
        if started:
            dist.destroy_process_group()


def _run_mode(args, device, mesh_shape) -> int:
    def run():
        if args.r:
            run_reconstruct(args.r, args.out_dir,
                            refine_poses=args.refine_poses,
                            live_snapshots=args.live_snapshots,
                            device=device,
                            distributed=args.distributed_expansion,
                            mesh_shape=mesh_shape)
        elif args.f:
            run_filter(args.f, args.out_dir, device=device)
        elif args.v:
            run_view(args.v, args.out_dir, patch_id=args.patch_id,
                     reoptimize=args.reoptimize, device=device)
        else:
            run_animate(args.a, args.out_dir)

    if args.profile is None:
        run()
        return 0
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    with profile(activities=acts) as prof:
        run()
    trace = os.path.join(args.profile, "trace.json")
    prof.export_chrome_trace(trace)
    print(f"wrote {trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
