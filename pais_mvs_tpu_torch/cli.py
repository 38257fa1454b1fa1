"""Command-line entry point of the port, mirroring the reference TMVS modes
(TMVS/TMVS.cpp:174-203) as ``pais_mvs_tpu/cli.py`` does:

  python -m pais_mvs_tpu_torch.cli -r scene.nvm[.nvm2|.mvs]   reconstruction
  python -m pais_mvs_tpu_torch.cli -f scene.mvs               post-filtering

It runs on the GPU (``--device cuda``, the default) and raises without one;
``--device cpu`` runs the plain PyTorch versions of the kernels. Config
resolution matches the reference: compiled defaults (TMVS.cpp:26-52)
overridden by ./config.txt if present (TMVS.cpp:178), re-applied after an
.mvs load (TMVS.cpp:92). Staged artifacts (init/seed/exp.mvs, exp.ply,
exp.psr, PMVS/PCMVS filter dumps, stats.json, log.txt) keep the
reference's names, and ``-r auto_save.mvs`` resumes from the autosave
checkpoint (its ``.state.npz`` sidecar carries the expansion frontier).

Modes the port does not have yet stop with a ``SystemExit`` that names the
ROADMAP item bringing them: bundle adjustment (``-b``), the viewer and the
replay (``-v``, ``-a``), feature seeding for an NVM without sparse points,
and the distributed expansion (``--distributed-expansion``,
``--mesh-shape``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from pais_mvs_tpu_torch import resolve_device
from pais_mvs_tpu_torch.config import MvsConfig, load_config_txt
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
from pais_mvs_tpu_torch.io import mvsbin
from pais_mvs_tpu_torch.io import nvm as nvm_io
from pais_mvs_tpu_torch.io.logmanager import LogManager

CONFIG_FILE_NAME = "config.txt"


def _not_ported(what: str, item: int, subject: str) -> SystemExit:
    return SystemExit(f"pais_mvs_tpu_torch: {what} is not ported yet "
                      f"(ROADMAP Queue 1 item {item}: {subject}); "
                      f"pais_mvs_tpu.cli has it")


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


def _build_reconstructor(path: str, out_dir: str,
                         device) -> Reconstructor:
    ext = path.rsplit(".", 1)[-1].lower()
    base_dir = os.path.dirname(os.path.abspath(path))
    if ext in ("nvm", "nvm2"):
        data = nvm_io.load_nvm(path, nvm2=(ext == "nvm2"))
        if not len(data.centers):
            raise _not_ported("an NVM without sparse points (feature "
                              "seeding)", 10, "features/")
        logger = LogManager(os.path.join(out_dir, "log.txt"))
        cfg = _resolve_config()
        images = _load_images(data.cameras, base_dir)
        rec = Reconstructor(data.cameras, images, cfg, logger=logger,
                            device=device)
        widths = [img.shape[1] for img in images]
        heights = [img.shape[0] for img in images]
        ipts = nvm_io.decenter_image_points(data, widths, heights)
        ipts = _pinhole_points(data.cameras, images, ipts, cfg)
        rec.load_seeds(data.centers, data.cam_masks, ipts, data.colors)
    elif ext == "mvs":
        logger = LogManager(os.path.join(out_dir, "log.txt"))
        f = mvsbin.read_mvs(path)
        cfg = _resolve_config(f.config)
        images = _load_images(f.cameras, base_dir)
        rec = Reconstructor(f.cameras, images, cfg, logger=logger,
                            device=device)
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
                    live_snapshots: bool = False, device="cuda") -> None:
    rec = _build_reconstructor(path, out_dir, device)
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


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pais-mvs-tpu-torch",
        description="patch-based multi-view stereo on one NVIDIA GPU "
                    "(the PyTorch/CUDA port)")
    ap.add_argument("-r", metavar="FILE", help="reconstruct (.nvm/.nvm2/.mvs)")
    ap.add_argument("-f", metavar="FILE", help="post-filter (.mvs)")
    ap.add_argument("-v", metavar="FILE", help="snapshot view (not ported)")
    ap.add_argument("-a", metavar="FILE", help="animate replay (not ported)")
    ap.add_argument("-o", "--out-dir", default=".", help="output directory")
    ap.add_argument("-b", "--refine-poses", action="store_true",
                    help="bundle adjustment (not ported)")
    ap.add_argument("--mesh-shape", default=None,
                    help="device mesh of the distributed expansion "
                         "(not ported)")
    ap.add_argument("--distributed-expansion", action="store_true",
                    help="SPMD expansion over several devices (not ported)")
    ap.add_argument("--live-snapshots", action="store_true",
                    help="refresh OUT_DIR/live_snapshot.ply at every "
                         "autosave so the growing cloud can be watched "
                         "mid-run (the reference's addPatchView hook)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)."
                         " 'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)

    if args.refine_poses:
        raise _not_ported("-b/--refine-poses (bundle adjustment)", 10,
                          "ops/bundle.py")
    if args.v or args.a:
        raise _not_ported("-v/-a (viewer and replay)", 10,
                          "diagnostics.py")
    if args.distributed_expansion or args.mesh_shape is not None:
        raise _not_ported("--distributed-expansion/--mesh-shape", 11,
                          "the SPMD expansion")
    if not (args.r or args.f):
        ap.print_help()
        return 1
    device = resolve_device(args.device)
    if args.r:
        run_reconstruct(args.r, args.out_dir,
                        live_snapshots=args.live_snapshots, device=device)
    else:
        run_filter(args.f, args.out_dir, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
