"""The reconstruction engine: batched seed refinement into a dense seed
cloud (seed stage only).

The PyTorch counterpart of ``pais_mvs_tpu/engine/reconstructor.py``
(:37-336, 869-984). Expansion, the post-filters, checkpoints and
multi-device refinement are not ported yet.

Division of labour: the device owns all pixel math (PSO/fitness/NCC/LOD);
the host owns the ragged bookkeeping (the arena).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pais_mvs_tpu_torch import resolve_device
from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.engine.arena import PatchArena
from pais_mvs_tpu_torch.io.pointcloud import write_ply
from pais_mvs_tpu_torch.models import patch as patch_mod
from pais_mvs_tpu_torch.models.camera import CameraParams, Scene, build_scene
from pais_mvs_tpu_torch.models.patch import PatchBatch
from pais_mvs_tpu_torch.ops import lifecycle as lc


class Reconstructor:
    def __init__(self, params: Sequence[CameraParams],
                 images: Sequence[np.ndarray], cfg: MvsConfig,
                 verbose: bool = True, device="cuda"):
        self.cfg = cfg
        self.verbose = verbose
        self.device = resolve_device(device)
        _t0 = time.time()
        self.scene: Scene = build_scene(params, images, cfg, self.device)
        _scene_s = time.time() - _t0
        self.arena = PatchArena(self.scene.num_cameras)
        self.neighbor_radius = cfg.neighbor_radius
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.rng_seed)
        self.stats: Dict[str, float] = {"scene_build_s": round(_scene_s, 2)}
        self._seed_pb: Optional[PatchBatch] = None

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    # ------------------------------------------------------------------
    # seeds
    # ------------------------------------------------------------------
    def load_seeds(self, centers: np.ndarray, cam_masks: np.ndarray,
                   img_points: np.ndarray,
                   colors: np.ndarray | None = None) -> None:
        """Ingest sparse points (pixel-coordinate measurements) and
        re-triangulate them (MVS::reCentering, mvs.cpp:135-145)."""
        pb = patch_mod.from_seeds(centers, cam_masks, img_points, colors,
                                  device=self.device)
        self._seed_pb = lc.prepare_seeds(self.scene, self.cfg, pb)

    def refine_seeds(self) -> int:
        """Batched MVS::refineSeedPatches (mvs.cpp:196-231). Returns the
        number of accepted seed patches."""
        pb = self._seed_pb
        B = pb.capacity
        # neighborRadius from the raw seed cloud (reference computes it
        # before refining, mvs.cpp:202)
        c = pb.center.cpu().numpy()
        ext = c.max(0) - c.min(0)
        vol = float(abs(ext[0] * ext[1] * ext[2]))
        if vol > 0:
            self.neighbor_radius = (vol ** (1. / 3.)
                                    * self.cfg.neighbor_radius_scalar)
        t0 = time.time()
        # re-optimization rounds with early stop: the reference loops each
        # patch until its refCam + camera set stabilize (<= camNum times,
        # patch.cpp:140-172); here a whole-batch round is skipped once
        # essentially every surviving patch has stabilized
        out = pb
        prev_ref = None
        prev_mask = None
        rounds_run = 0
        for rnd in range(self.cfg.seed_refine_rounds):
            # the runtime filter applies ONCE after the whole loop
            # (mvs.cpp:217); intermediate rounds must not kill seeds that
            # can still recover (e.g. minCorrelation mid-loop)
            out, _ = self._refine_all(out, is_seed=True, rounds=1,
                                      final_filter=False)
            rounds_run += 1
            ref = out.ref_cam.cpu().numpy()
            mask = out.cam_mask.cpu().numpy()
            alive = out.valid.cpu().numpy()
            if prev_ref is not None and alive.any():
                changed = ((ref != prev_ref)
                           | (mask != prev_mask).any(axis=1)) & alive
                if changed.sum() <= max(1, int(0.01 * alive.sum())):
                    break
            prev_ref, prev_mask = ref, mask
        out = lc.apply_runtime_filter(self.scene, self.cfg, out)
        keep = out.valid.cpu().numpy()
        n = int(keep.sum())
        self._append_to_arena(out, keep, is_seed=True)
        self._update_neighbor_radius()
        dt = time.time() - t0
        self.stats["seed_refine_s"] = dt
        self.stats["seed_rounds"] = rounds_run
        self.stats["seed_accepted"] = n
        self.stats["seed_pps"] = round(n / max(dt, 1e-9), 2)
        self._log(f"seeds: {n}/{B} accepted in {dt:.2f}s "
                  f"({rounds_run} rounds, neighborRadius "
                  f"{self.neighbor_radius:.5f})")
        return n

    # ------------------------------------------------------------------
    # device batching
    # ------------------------------------------------------------------
    def _chunk_sizes(self, B: int):
        """Chunk plan: full batches plus a LADDER of smaller tail sizes
        (bs/2, bs/4, floor 64) so a 400-seed load doesn't pad to 1024."""
        bs = self.cfg.batch_size
        ladder = sorted({bs, max(bs // 2, 64), max(bs // 4, 64)})
        sizes = []
        rem = B
        while rem > 0:
            size = next((s for s in ladder if s >= rem), bs)
            sizes.append(size)
            rem -= size
        return sizes

    def _refine_all(self, pb: PatchBatch, is_seed: bool, rounds: int,
                    final_filter: bool = True):
        """Refine an arbitrary-size batch in chunks of the ladder's sizes
        (padding rows are invalid). Returns (batch [B], iterations [B])."""
        B = pb.capacity
        sizes = self._chunk_sizes(B)
        pad = sum(sizes) - B
        if pad:
            filler = patch_mod.take(pb, np.zeros(pad, dtype=np.int64))
            filler = filler.replace(valid=torch.zeros_like(filler.valid))
            pb = patch_mod.concat(pb, filler)
        outs, its = [], []
        s = 0
        for size in sizes:
            chunk = patch_mod.take(pb, np.arange(s, s + size))
            s += size
            res = lc.refine_batch(self.scene, self.cfg, chunk,
                                  self.neighbor_radius, is_seed, rounds,
                                  final_filter, generator=self.generator)
            outs.append(res.batch)
            its.append(res.iterations)
        merged = outs[0]
        for o in outs[1:]:
            merged = patch_mod.concat(merged, o)
        return (patch_mod.take(merged, np.arange(B)),
                torch.cat(its)[:B])

    def _append_to_arena(self, out: PatchBatch, keep: np.ndarray,
                         is_seed: bool) -> np.ndarray:
        """Append the kept rows in order (ids are assigned sequentially)."""
        idx = np.nonzero(keep)[0]
        if len(idx) == 0:
            return np.zeros(0, dtype=np.int64)
        h = out.numpy()
        return self.arena.append(
            center=h["center"][idx], normal_sph=h["normal_sph"][idx],
            cam_mask=h["cam_mask"][idx], ref_cam=h["ref_cam"][idx],
            depth=h["depth"][idx], lod=h["lod"][idx],
            fitness=h["fitness"][idx], correlation=h["correlation"][idx],
            priority=h["priority"][idx], color=h["color"][idx],
            img_point=h["img_point"][idx],
            is_seed=np.full(len(idx), is_seed),
        )

    def _update_neighbor_radius(self):
        nr = self.arena.neighbor_radius(self.cfg.neighbor_radius_scalar)
        if nr > 0:
            self.neighbor_radius = nr

    # ------------------------------------------------------------------
    # output
    # ------------------------------------------------------------------
    def live_centers(self) -> np.ndarray:
        return self.arena.data["center"][self.arena.live_ids()]

    def write_ply(self, path: str, deleted: bool = False) -> None:
        a = self.arena
        ids = (np.asarray(a.deleted_ids, dtype=np.int64) if deleted
               else a.live_ids())
        write_ply(path, a.data["center"][ids], a.normals(ids),
                  a.data["color"][ids])
