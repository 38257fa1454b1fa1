"""The reconstruction engine: batched seed refinement, wavefront expansion
over the cell grids, post-filtering, and the ``.mvs`` checkpoints.

The PyTorch counterpart of ``pais_mvs_tpu/engine/reconstructor.py``,
with its data-parallel refine over the ranks of a mesh's patch axis
(``_refine_dp``) and the SPMD expansion (``expand_distributed``), in which
every rank runs the same host loop on the same gathered results.

Inversion of the reference's control flow (SURVEY.md §7): instead of a
serial priority queue popping ONE patch and running ONE swarm
(MVS::expansionPatches, TMVS/mvs/mvs.cpp:233-275), each round takes the
best-priority frontier slice, generates ALL its cell-expansion candidates,
and refines them in one batched device program. Ordering-sensitive cell
capacity semantics are enforced host-side in parent-priority order, so
``wavefront_size=1`` degenerates to the reference's best-first behaviour.

Division of labour: the device owns all pixel math (PSO/fitness/NCC/LOD);
the host owns the ragged bookkeeping (arena, cell buckets, frontier), in
numpy and the native runtime (``native/``).

On the card every seed round, expansion chunk and ``expand_step`` replays
the refine from a CUDA graph captured once per signature
(``ops/graphs.py``, the counterpart of the JAX package's jitted
``refine_batch``), ``psoExitChunk > 0`` included;
``Reconstructor(graphs=False)`` refines eagerly, and the stated eager
paths (the CPU, a gloo mesh) are logged once and counted in
``stats["refine_graphs"]``.
"""

from __future__ import annotations

import functools
import math
import os
import time
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pais_mvs_tpu_torch import config as cfg_mod
from pais_mvs_tpu_torch import native as native_rt
from pais_mvs_tpu_torch import resolve_device
from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.engine.arena import PatchArena
from pais_mvs_tpu_torch.engine.cellgrid import CellGrids
from pais_mvs_tpu_torch.io import npz
from pais_mvs_tpu_torch.io.mvsbin import MvsPatchData, write_mvs
from pais_mvs_tpu_torch.io.pointcloud import write_ply, write_psr
from pais_mvs_tpu_torch.models import patch as patch_mod
from pais_mvs_tpu_torch.models.camera import CameraParams, Scene, build_scene
from pais_mvs_tpu_torch.models.patch import PatchBatch
from pais_mvs_tpu_torch.ops import graphs as graphs_mod
from pais_mvs_tpu_torch.ops.cuda_fitness import CAMERA_SPAN, CAMERA_TILE
from pais_mvs_tpu_torch.ops import lifecycle as lc
from pais_mvs_tpu_torch.parallel import mesh as mesh_mod
from pais_mvs_tpu_torch.parallel.sharded import patch_seed, refine_sharded
from pais_mvs_tpu_torch.trace import Trace


def _log_to(logger, verbose: bool, msg: str) -> None:
    if logger is not None:
        logger.log(msg)
    elif verbose:
        print(msg, flush=True)


class Reconstructor:
    # autosave cadence in new patches (mvs.cpp:265-268 uses 500); the
    # live-snapshot hook (addPatchView analog) fires at the same points
    autosave_interval = 500

    def __init__(self, params: Sequence[CameraParams],
                 images: Sequence[np.ndarray], cfg: MvsConfig,
                 verbose: bool = True, use_native: Optional[bool] = None,
                 logger=None, device="cuda", mesh=None, graphs: bool = True,
                 trace: Optional[Trace] = None):
        self.cfg = cfg
        # the job's spans and counters (trace.py): the CLI's job's, else
        # this object's own
        self.trace = tr = Trace() if trace is None else trace
        self.params = list(params)
        self.verbose = verbose
        self.logger = logger
        self.device = resolve_device(device)
        # the native C++ host runtime (cell grids, candidate generation,
        # insertion, filters, neighbour counts) unless the caller asks for
        # the pure-Python mirror; a failed build raises here
        self.use_native = True if use_native is None else bool(use_native)
        if self.use_native:
            native_rt.lib()
        split: Dict[str, float] = {}
        with tr.span("scene/build") as build:
            self.scene: Scene = build_scene(params, images, cfg,
                                            self.device, split=split,
                                            trace=tr)
        scene_s = build.seconds
        self.widths = [img.shape[1] for img in images]
        self.heights = [img.shape[0] for img in images]
        self.arena = PatchArena(self.scene.num_cameras)
        self.grids = None
        self.neighbor_radius = cfg.neighbor_radius
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.rng_seed)
        self.mesh = mesh
        self.live_snapshot_dir: Optional[str] = None
        self.resumed = False
        # the JAX package's distributed-expansion record (checkpointed as
        # cand_done_*): carried through load/save so the sidecar format
        # stays one format
        self._dist_cand_done: Dict[int, np.ndarray] = {}
        # host copies of rig data for cheap bookkeeping math
        rig = self.scene.rig
        f64 = lambda t: t.cpu().numpy().astype(np.float64)
        self.np_center = f64(rig.center)
        self.np_optical = f64(rig.optical)
        self.np_R = f64(rig.R)
        self.np_focal = f64(rig.focal)
        self.np_principal = f64(rig.principal)
        # the refine's CUDA graphs (ops/graphs.py), one per signature, in
        # one memory pool freed with this object; graphs=False is the eager
        # arm. A mesh on gloo refines eagerly: its collectives stage
        # through host memory
        self.graphs = graphs_mod.RefineGraphs(
            enabled=graphs, log=functools.partial(_log_to, logger, verbose),
            trace=tr)
        gloo = mesh is not None and not (mesh.patch.capturable
                                         and mesh.view.capturable)
        self._refine = (self.graphs.eager_refine(graphs_mod.EAGER_GLOO)
                        if gloo else self.graphs.refine)
        # the scene build's split: host undistortion, uploads, the pyramid
        # kernels (CUDA events; the twins' host time on the CPU) and the
        # rest (the rig, allocations, launches' host side)
        self.stats: Dict[str, object] = {
            "scene_build_s": round(scene_s, 2),
            **{f"scene_{k}": v for k, v in split.items()},
            "scene_other_s": scene_s - sum(split.values()),
            "refine_graphs": self.graphs.counts, "refine_host_s": 0.0}
        self._seed_pb: Optional[PatchBatch] = None
        self._seed_masks: Optional[np.ndarray] = None    # on the host
        # PSO stream of the multi-rank paths, made on first use
        self._patch_gen: Optional[torch.Generator] = None
        # data-parallel refine over the ranks of the mesh's patch axis
        # (pais_mvs_tpu/engine/reconstructor.py:73-87 over local devices):
        # "on", or "auto" on a card; a world of 1 keeps the one-rank path
        self._dp = None
        dp = cfg.data_parallel
        want_dp = dp == "on" or (dp == "auto" and self.device.type == "cuda")
        if (want_dp and mesh is not None and mesh.patch.size > 1
                and cfg.batch_size % mesh.patch.size == 0):
            self._dp = mesh.patch
            self._log(f"data-parallel refine over {mesh.patch.size} ranks "
                      f"of the patch axis")

    # ------------------------------------------------------------------
    # logging
    # ------------------------------------------------------------------
    def _log(self, msg: str):
        _log_to(self.logger, self.verbose, msg)

    def _log_graphs(self):
        """Record and log the refine graphs' counts, capture time and
        pool, and the host's time in the refine's enqueue so far."""
        tr = self.trace
        self.stats["refine_graph_capture_s"] = round(
            tr.total("refine/capture"), 3)
        self.stats["refine_graph_pool_bytes"] = self.graphs.pool_bytes
        self.stats["refine_host_s"] = tr.total("refine/enqueue")
        self._log(self.graphs.summary())

    def trace_summary(self) -> dict:
        """``stats.json``'s ``trace``: the spans, the counters (the refine
        graphs' from their ``counts``) and the rounds table."""
        out = self.trace.summary()
        c = self.graphs.counts
        out["counters"].update(graph_keys_captured=c["captured"],
                               graph_first_runs=c["captured"],
                               graph_replays=c["replayed"])
        return out

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
        self._seed_masks = np.asarray(cam_masks, dtype=bool)

    def _rehydrate(self, patches) -> PatchBatch:
        """Rebuild derived patch state from an .mvs checkpoint's
        (center, normal, cams, fitness, correlation) tuples."""
        B = len(patches.centers)
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                        device=dev)
        pb = patch_mod.empty_batch(B, self.scene.num_cameras, dev).replace(
            center=f32(patches.centers), normal_sph=f32(patches.normal_sph),
            cam_mask=torch.as_tensor(np.asarray(patches.cam_masks,
                                                dtype=bool), device=dev),
            fitness=f32(patches.fitness),
            correlation=f32(patches.correlation),
            valid=torch.ones(B, dtype=torch.bool, device=dev),
            is_seed=torch.ones(B, dtype=torch.bool, device=dev))
        return lc.rehydrate_batch(self.scene, self.cfg, pb,
                                  self.neighbor_radius)

    def load_seeds_from_mvs(self, patches) -> None:
        """Resume reconstruction from an .mvs checkpoint (the reference's
        -r path for .mvs inputs, TMVS.cpp:87-88)."""
        self._seed_pb = self._rehydrate(patches)
        self._seed_masks = np.asarray(patches.cam_masks, dtype=bool)

    def adopt_loaded_patches(self) -> None:
        """Adopt checkpoint patches as the final set (the -f path,
        TMVS.cpp:131-136)."""
        out = self._seed_pb
        self._append_to_arena(out, out.valid.cpu().numpy(), is_seed=True)
        self._update_neighbor_radius()

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
        with self.trace.span("seeds") as seeds:
            n, rounds_run = self._refine_seed_rounds(pb)
        dt = seeds.seconds
        self.stats["seed_refine_s"] = dt
        self.stats["seed_rounds"] = rounds_run
        self.stats["seed_accepted"] = n
        self._log(f"seeds: {n}/{B} accepted in {dt:.2f}s "
                  f"({rounds_run} rounds, neighborRadius "
                  f"{self.neighbor_radius:.5f})")
        self._log_graphs()
        return n

    def _refine_seed_rounds(self, pb: PatchBatch):
        """The seed refine's rounds, its runtime filter and the accepted
        seeds' insert. Returns (accepted, rounds run)."""
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
            self._count_cams(self._seed_masks if prev_mask is None
                             else prev_mask)
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
        self.trace.count("inserted", n)
        self._update_neighbor_radius()
        return n, rounds_run

    def _count_cams(self, masks: np.ndarray) -> None:
        """Counters of the cameras the rows of a refine enter it with, from
        their host camera masks [N, C] (no device work): ``scored_cams``
        sums them, ``k1_tiled_rows`` counts the rows that see more cameras
        than K1's one-pass rig holds (``CAMERA_TILE``), and
        ``k1_resampled_rows`` those of them that see more than a wide K1
        block holds (``CAMERA_SPAN``), so that K1 samples part of them
        twice."""
        n = masks.sum(axis=1)
        self.trace.count("scored_cams", int(n.sum()))
        self.trace.count("k1_tiled_rows", int((n > CAMERA_TILE).sum()))
        self.trace.count("k1_resampled_rows", int((n > CAMERA_SPAN).sum()))

    # ------------------------------------------------------------------
    # device batching
    # ------------------------------------------------------------------
    def _patch_generator(self, index: int) -> torch.Generator:
        """This rank's PSO stream, of patch index ``index``: seeded from
        (rngSeed, index) alone, so the view ranks of a patch slice draw the
        same particles, and continued across rounds, so it never
        replays."""
        if self._patch_gen is None:
            self._patch_gen = torch.Generator(self.device).manual_seed(
                patch_seed(self.cfg.rng_seed, index))
        return self._patch_gen

    def _chunk_sizes(self, B: int):
        """Chunk plan: full batches plus a LADDER of smaller tail sizes
        (bs/2, bs/4, floor 64) so a 400-seed load doesn't pad to 1024.
        Under the data-parallel refine every size divides over the patch
        axis: the floor rounds UP to a multiple of its size."""
        bs = self.cfg.batch_size
        n_dp = 1 if self._dp is None else self._dp.size
        floor = -(-64 // n_dp) * n_dp
        ladder = sorted({bs, max(bs // 2 // n_dp * n_dp, floor),
                         max(bs // 4 // n_dp * n_dp, floor)})
        sizes = []
        rem = B
        while rem > 0:
            size = next((s for s in ladder if s >= rem), bs)
            sizes.append(size)
            rem -= size
        return sizes

    def _refine_all_async(self, pb: PatchBatch, is_seed: bool, rounds: int,
                          final_filter: bool = True):
        """Dispatch an arbitrary-size batch in chunks of the ladder's sizes
        (padding rows are invalid) WITHOUT waiting: returns a handle for
        ``_merge`` / ``_refine_fetch``. On the card the launches run
        asynchronously, so the caller can do host work (the pipelined
        expand's next-round candidate generation) before the fetch. Two
        CUDA events around the launches time their launch-to-completion
        span: from the stream reaching the first launch to the end of the
        last. While the host enqueues slower than the device runs, the
        span holds the device's idle gaps too, so it bounds the device's
        busy time from above and is not that time. On the CPU it is the
        host clock around the dispatch, which is the work. The span
        ``refine/enqueue`` holds the host's time in here: the chunking
        (``refine/chunk``), the draws, the copies into a graph's inputs,
        the replays and the clones of its outputs (``ops/graphs.py``), and
        each key's first run and capture. A chunk's index upload is a
        copy from pageable memory, which waits for the stream to drain:
        on the card that wait is its own span, ``refine/wait``."""
        tr = self.trace
        with tr.span("refine/enqueue") as enqueue:
            cuda = self.device.type == "cuda"
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            B = pb.capacity
            sizes = self._chunk_sizes(B)
            pad = sum(sizes) - B
            if pad:
                self._drain()
                with tr.span("refine/chunk"):
                    filler = patch_mod.take(pb,
                                            np.zeros(pad, dtype=np.int64))
                    filler = filler.replace(
                        valid=torch.zeros_like(filler.valid))
                    pb = patch_mod.concat(pb, filler)
            tr.count("refined_rows", B + pad)
            tr.count("padded_rows", pad)
            results = []
            s = 0
            for size in sizes:
                self._drain()
                with tr.span("refine/chunk"):
                    chunk = patch_mod.take(pb, np.arange(s, s + size))
                s += size
                if self._dp is not None:
                    res = self._refine_dp(chunk, is_seed, rounds,
                                          final_filter)
                else:
                    res = self._refine(
                        self.scene, self.cfg, chunk, self.neighbor_radius,
                        is_seed, rounds, final_filter,
                        generator=self.generator)
                results.append(res)
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
        timer = (start, end) if cuda else enqueue.seconds
        return results, B, timer

    def _drain(self) -> None:
        """On the card, wait for the stream to drain (``refine/wait``):
        the index upload of ``patch_mod.take`` would wait there anyway."""
        if self.device.type == "cuda":
            with self.trace.span("refine/wait"):
                torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def _merge(handle):
        """The dispatched chunks as one batch [B] and iterations [B], on
        the refine's device."""
        results, B, _ = handle
        merged = results[0].batch
        for r in results[1:]:
            merged = patch_mod.concat(merged, r.batch)
        its = torch.cat([r.iterations for r in results])
        return patch_mod.take(merged, np.arange(B)), its[:B]

    def _refine_fetch(self, handle):
        """Move the dispatched results to the host (once per round) and
        merge them. Returns ({field: numpy [B, ...]}, iterations [B], the
        refine's launch-to-completion span in seconds)."""
        merged, its = self._merge(handle)
        host = merged.numpy()
        its = its.cpu().numpy()
        self.trace.count("fetch_bytes", its.nbytes + sum(
            v.nbytes for v in host.values()))
        timer = handle[2]
        if isinstance(timer, tuple):
            timer[1].synchronize()
            device_s = timer[0].elapsed_time(timer[1]) / 1e3
        else:
            device_s = timer
        return host, its, device_s

    def _refine_all(self, pb: PatchBatch, is_seed: bool, rounds: int,
                    final_filter: bool = True):
        """Refine an arbitrary-size batch; returns (batch [B], iterations
        [B]) on the refine's device."""
        return self._merge(self._refine_all_async(pb, is_seed, rounds,
                                                  final_filter))

    def _refine_dp(self, chunk: PatchBatch, is_seed: bool, rounds: int,
                   final_filter: bool = True, draws=None) -> lc.RefineResult:
        """Patch-axis data-parallel ``refine_batch``
        (pais_mvs_tpu/engine/reconstructor.py:273-305): this rank refines
        its slice of the chunk (flat K1, no view axis) with the stream of
        its patch index, or with ``draws`` (one PsoDraws per round for the
        whole chunk) when given; every rank returns the whole chunk."""
        return refine_sharded(
            self.scene, self.cfg, chunk, self.neighbor_radius, is_seed,
            rounds, self._dp, None, final_filter=final_filter, draws=draws,
            generator=self._patch_generator(self._dp.index),
            refine=self._refine)

    def _append_to_arena(self, out: PatchBatch, keep: np.ndarray,
                         is_seed: bool) -> np.ndarray:
        return self._append_rows(out.numpy(), np.nonzero(keep)[0], is_seed)

    def _append_rows(self, host: dict, idx: np.ndarray,
                     is_seed: bool) -> np.ndarray:
        """Append the given rows of a host batch IN ORDER (ids are assigned
        sequentially, so callers that pre-registered grid ids must pass
        the same order)."""
        if len(idx) == 0:
            return np.zeros(0, dtype=np.int64)
        return self.arena.append(
            center=host["center"][idx], normal_sph=host["normal_sph"][idx],
            cam_mask=host["cam_mask"][idx], ref_cam=host["ref_cam"][idx],
            depth=host["depth"][idx], lod=host["lod"][idx],
            fitness=host["fitness"][idx],
            correlation=host["correlation"][idx],
            priority=host["priority"][idx], color=host["color"][idx],
            img_point=host["img_point"][idx],
            is_seed=np.full(len(idx), is_seed),
        )

    def _update_neighbor_radius(self):
        nr = self.arena.neighbor_radius(self.cfg.neighbor_radius_scalar)
        if nr > 0:
            self.neighbor_radius = nr

    # ------------------------------------------------------------------
    # expansion
    # ------------------------------------------------------------------
    def _strategy_order(self, frontier: np.ndarray) -> np.ndarray:
        """Queue pop order over the frontier per the configured expansion
        strategy (MVS::getPatchIdFromQueue, mvs.cpp:632-788)."""
        strategy = self.cfg.expansion_strategy
        if strategy == cfg_mod.EXPANSION_WORST_FIRST:
            return np.argsort(-self.arena.data["priority"][frontier],
                              kind="stable")
        if strategy == cfg_mod.EXPANSION_BREADTH_FIRST:
            return np.arange(len(frontier))               # FIFO by id
        if strategy == cfg_mod.EXPANSION_DEPTH_FIRST:
            return np.arange(len(frontier))[::-1]         # LIFO by id
        # best-first: lowest priority first (mvs.cpp:656-693)
        return np.argsort(self.arena.data["priority"][frontier],
                          kind="stable")

    def _is_neighbor(self, c1, n1, c2, n2) -> np.ndarray:
        """Plane-to-plane distance test (Patch::isNeighbor, patch.cpp:6-23).
        Vectorized over leading dims of c2/n2."""
        d = c2 - c1
        dist = np.abs(d @ n1) + np.abs(np.sum(d * n2, axis=-1))
        return dist <= self.neighbor_radius

    def _skip_neighbor_cell(self, occupants: List[int], parent_id: int) -> bool:
        """MVS::skipNeighborCell (mvs.cpp:792-807)."""
        cfg = self.cfg
        a = self.arena
        if len(occupants) >= cfg.max_cell_patch_num:
            return True
        if not occupants:
            return False
        occ = np.asarray(occupants)
        occ = occ[a.alive[occ]]
        if len(occ) == 0:
            return False
        if np.any(a.data["correlation"][occ] > cfg.min_correlation):
            return True
        c1 = a.data["center"][parent_id]
        n1 = a.normals([parent_id])[0]
        c2 = a.data["center"][occ]
        n2 = a.normals(occ)
        return bool(np.any(self._is_neighbor(c1, n1, c2, n2)))

    def _expansion_centers(self, cams, cxs, cys, parent_ids) -> np.ndarray:
        """Ray through each cell center intersected with the parent plane
        (MVS::getExpansionPatchCenter, mvs.cpp:809-836). Vectorized."""
        cfg = self.cfg
        cams = np.asarray(cams)
        px = (np.asarray(cxs) + 0.5) * cfg.cell_size
        py = (np.asarray(cys) + 0.5) * cfg.cell_size
        f = self.np_focal[cams]
        pp = self.np_principal[cams]
        d_cam = np.stack([(px - pp[:, 0]) / f[:, 0],
                          (py - pp[:, 1]) / f[:, 1],
                          np.ones_like(px)], axis=-1)
        R = self.np_R[cams]
        v12 = np.einsum("nji,nj->ni", R, d_cam)       # R^T d (at depth 1)
        cc = self.np_center[cams]
        pc = self.arena.data["center"][parent_ids]
        pn = self.arena.normals(parent_ids)
        u = np.sum(pn * (pc - cc), axis=-1) / np.sum(pn * v12, axis=-1)
        return cc + u[:, None] * v12

    def _expand_visible_cameras(self, normals: np.ndarray,
                                parent_masks: np.ndarray) -> np.ndarray:
        """Patch::expandVisibleCamera (patch.cpp:723-761)."""
        cfg = self.cfg
        facing = -normals @ self.np_optical.T          # [N, C]
        mask = facing >= cfg.visible_correlation
        lacking = mask.sum(axis=1) < cfg.min_cam_num
        fallback = parent_masks & (facing >= cfg.visible_correlation / 2.0)
        mask[lacking] |= fallback[lacking]
        return mask

    def _grids_build(self):
        cls = native_rt.NativeCellGrids if self.use_native else CellGrids
        return cls.build(self.arena, self.widths, self.heights,
                         self.cfg.cell_size)

    def _insert_time_cell_filter(self, cam_mask, img_points) -> bool:
        """The cell-density clause of MVS::runtimeFiltering
        (mvs.cpp:877-895) applied at insertion time: reject when EVERY
        visible view's target cell is already full."""
        cfg = self.cfg
        if self.use_native:
            return self.grids.insert_time_filter(cam_mask, img_points,
                                                 cfg.max_cell_patch_num)
        full = 0
        cams = np.nonzero(cam_mask)[0]
        for cam in cams:
            cx, cy = self.grids.cell_of(img_points[cam])
            occ = self.grids.cell(int(cam), cx, cy)
            if len(occ) >= cfg.max_cell_patch_num:
                full += 1
        return full < len(cams)

    def _generate_candidates(self, parents):
        """Per-round candidate cells: (parent, cam, cx, cy) arrays after
        skipNeighborCell + the per-round cell budget (mvs.cpp:529-564,
        792-807). Native C++ path with a pure-Python mirror."""
        cfg = self.cfg
        a = self.arena
        if self.use_native:
            n = a.count
            return self.grids.candidates(
                parents, a.data["center"][:n], a.data["normal_sph"][:n],
                a.data["correlation"][:n], a.alive[:n],
                a.data["cam_mask"][:n], a.data["img_point"][:n],
                cfg.min_correlation, self.neighbor_radius,
                cfg.max_cell_patch_num)
        cand_parent, cand_cam, cand_cx, cand_cy = [], [], [], []
        seen_cells = {}
        for pid in parents:
            mask = a.data["cam_mask"][pid]
            ipts = a.data["img_point"][pid]
            for cam in np.nonzero(mask)[0]:
                cam = int(cam)
                cx, cy = self.grids.cell_of(ipts[cam])
                for nx, ny in ((cx - 1, cy), (cx, cy - 1),
                               (cx + 1, cy), (cx, cy + 1)):
                    if not self.grids.in_map(cam, nx, ny):
                        continue
                    occ = self.grids.cell(cam, nx, ny)
                    if self._skip_neighbor_cell(occ, int(pid)):
                        continue
                    key = (cam, nx, ny)
                    cnt = seen_cells.get(key, len(occ))
                    if cnt >= cfg.max_cell_patch_num:
                        continue
                    seen_cells[key] = cnt + 1
                    cand_parent.append(int(pid))
                    cand_cam.append(cam)
                    cand_cx.append(nx)
                    cand_cy.append(ny)
        return (np.asarray(cand_parent, dtype=np.int64),
                np.asarray(cand_cam, dtype=np.int32),
                np.asarray(cand_cx, dtype=np.int32),
                np.asarray(cand_cy, dtype=np.int32))

    def expand(self, max_rounds: int = 10_000,
               autosave_path: Optional[str] = None) -> int:
        """Wavefront expansion (MVS::expansionPatches, mvs.cpp:233-275).
        Returns total patch count.

        With ``cfg.pipeline_expansion`` the host candidate generation of
        round n+1 overlaps the device refine of round n: prepare(n+1) runs
        against the PRE-insert(n) grid while refine(n) is in flight, then
        insert(n) lands. Two bounded semantic shifts vs the serial loop
        (both of the same class as changing wavefront_size, which the
        reference treats as tunable): (a) patches inserted in round n join
        the frontier one round later; (b) candidates of round n+1 are
        generated against a grid missing round n's inserts — the
        insert-time live-grid re-check below restores the density/
        skipNeighborCell verdicts exactly, so only candidate *generation*
        sees stale counts (it may generate candidates a fresh insert would
        have suppressed; they die at insert time).

        Each loop trip is an ``expand/round`` span with the round's id;
        a round's fetch and insert carry its id also where they land in
        the next trip (pipelined). ``stats["expansion_s"]`` is the
        ``expand`` span: the grid build and the rounds.
        ``stats["expansion_device_s"]`` sums the refines' launch-to-
        completion spans: CUDA events around each round's launches (the
        host clock on the CPU), never the wait for the fetch, which under
        pipelining sees only the part of the refine that outlasts the
        host's work. A launch-bound refine leaves the device idle inside
        these spans; its busy time needs a profiler trace.
        """
        cfg = self.cfg
        a = self.arena
        tr = self.trace
        total_refined = 0
        t_device = 0.0
        host0 = tr.total("refine/enqueue")
        self._save_time = a.count // self.autosave_interval
        pipeline = cfg.pipeline_expansion
        C = self.scene.num_cameras
        dev = self.device

        def prepare():
            """Pop a wavefront and generate+prep its candidates. Returns
            None when the frontier is empty, "skip" for a consumed round
            with no refinable candidates, else the round dict."""
            frontier = a.live_ids()
            frontier = frontier[~a.expanded[frontier]]
            if len(frontier) == 0:
                return None
            order = self._strategy_order(frontier)
            parents = frontier[order][:cfg.wavefront_size]
            a.expanded[parents] = True
            tr.count("rounds")
            tr.count("parents", len(parents))

            # candidate generation over 4-neighbour cells of every view
            with tr.span("expand/candidates"):
                cand_parent, cand_cam, cand_cx, cand_cy = \
                    self._generate_candidates(parents)
            if len(cand_parent) == 0:
                return "skip"

            centers = self._expansion_centers(cand_cam, cand_cx, cand_cy,
                                              cand_parent)
            normals = a.normals(cand_parent)
            masks = self._expand_visible_cameras(
                normals, a.data["cam_mask"][cand_parent])
            ok = masks.sum(axis=1) >= cfg.min_cam_num
            ok &= np.all(np.isfinite(centers), axis=1)
            if not ok.any():
                return "skip"
            centers_k, normals_k, masks_k = centers[ok], normals[ok], \
                masks[ok]
            N = len(centers_k)
            tr.count("candidates", N)
            self._count_cams(masks_k)
            sph = np.stack([np.arccos(np.clip(normals_k[:, 2], -1, 1)),
                            np.arctan2(normals_k[:, 1], normals_k[:, 0])],
                           -1)
            f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32),
                                            device=dev)
            pb = patch_mod.empty_batch(N, C, dev).replace(
                center=f32(centers_k), normal_sph=f32(sph),
                cam_mask=torch.as_tensor(masks_k, device=dev),
                valid=torch.ones(N, dtype=torch.bool, device=dev))
            return dict(parents=parents, pb=pb, N=N,
                        parents_kept=np.asarray(cand_parent)[ok],
                        cams_kept=np.asarray(cand_cam)[ok],
                        cx_kept=np.asarray(cand_cx)[ok],
                        cy_kept=np.asarray(cand_cy)[ok])

        def insert(prep, out, rnd, inflight_parents=None):
            """Sequential insert in STRATEGY-POP order: the cell-density
            clause AND the skipNeighborCell re-check both run against the
            live grid state (cells fill as we insert, exactly as in the
            reference's serial loop). Candidates already arrive grouped by
            parent in the strategy's pop order (cam-outer/offset-inner
            within a parent, matching mvs.cpp:535-549), so arrival order IS
            the serial order."""
            keep = out["valid"]
            parents_kept = prep["parents_kept"]
            cams_kept = prep["cams_kept"]
            cx_kept = prep["cx_kept"]
            cy_kept = prep["cy_kept"]
            order = np.arange(len(parents_kept))
            if self.use_native:
                # one native pass decides + registers; rows then land in
                # the arena in the same order, so ids line up
                n_arena = a.count
                accept = self.grids.batch_insert(
                    order, keep, out["cam_mask"],
                    out["img_point"].astype(np.float64),
                    parents_kept, cams_kept, cx_kept, cy_kept,
                    a.data["center"][:n_arena],
                    a.data["normal_sph"][:n_arena],
                    a.data["correlation"][:n_arena],
                    a.alive[:n_arena].astype(np.uint8),
                    out["center"], out["normal_sph"], out["correlation"],
                    cfg.min_correlation, self.neighbor_radius,
                    cfg.max_cell_patch_num, a.count)
                sel = order[accept[order]]
                self._append_rows(out, sel, is_seed=False)
                inserted = len(sel)
            else:
                inserted = 0
                for i in order:
                    if not keep[i]:
                        continue
                    cm = out["cam_mask"][i]
                    ip = out["img_point"][i]
                    if not self._insert_time_cell_filter(cm, ip):
                        continue
                    occ = [q for q in self.grids.cell(
                               int(cams_kept[i]), int(cx_kept[i]),
                               int(cy_kept[i])) if a.alive[q]]
                    if self._skip_neighbor_cell(occ, int(parents_kept[i])):
                        continue
                    ids = self._append_rows(out, np.asarray([i]),
                                            is_seed=False)
                    self.grids.insert_patch(int(ids[0]), cm, ip)
                    inserted += 1
            tr.count("inserted", inserted)
            self._log(f"round {rnd}: {len(prep['parents'])} parents -> "
                      f"{prep['N']} candidates -> {inserted} inserted "
                      f"(total {len(a.live_ids())})")
            # autosave every 500 new patches (mvs.cpp:265-268), frontier
            # included via the sidecar. In pipelined mode the NEXT round's
            # parents are already popped (expanded=True) with their
            # children only in flight — checkpoint them UNEXPANDED so a
            # crash+resume re-pops them instead of silently losing their
            # subtrees ("this round never happened" is a consistent state;
            # the serial path can never write the inconsistent one).
            if autosave_path and \
                    a.count // self.autosave_interval > self._save_time:
                self._save_time = a.count // self.autosave_interval
                self._autosave(autosave_path, inflight_parents)

        def land(prep, handle, rnd, inflight_parents=None):
            """Round ``rnd``'s fetch and insert."""
            nonlocal t_device
            with tr.span("refine/fetch", round=rnd):
                out, _, dt = self._refine_fetch(handle)
            t_device += dt
            with tr.span("expand/insert", round=rnd):
                insert(prep, out, rnd, inflight_parents)

        with tr.span("expand") as expand:
            with tr.span("expand/grids"):
                self.grids = self._grids_build()
                self._update_neighbor_radius()
            pending = None          # (prep, handle, round#) awaiting insert
            rnd = 0
            while rnd < max_rounds:
                with tr.span("expand/round", round=rnd):
                    with tr.span("expand/prepare"):
                        prep = prepare()
                    if prep is None and pending is None:
                        break
                    handle = None
                    if isinstance(prep, dict):
                        handle = self._refine_all_async(
                            prep["pb"], is_seed=False, rounds=1)
                        total_refined += prep["N"]
                    if pending is not None:
                        pprep, phandle, prnd = pending
                        pending = None
                        land(pprep, phandle, prnd,
                             inflight_parents=(prep["parents"]
                                               if isinstance(prep, dict)
                                               else None))
                    if handle is not None:
                        if pipeline:
                            pending = (prep, handle, rnd)
                        else:
                            land(prep, handle, rnd)
                rnd += 1
            if pending is not None:     # max_rounds hit with one in flight
                pprep, phandle, prnd = pending
                with tr.span("expand/round", round=prnd):
                    land(pprep, phandle, prnd)
            self._update_neighbor_radius()
        wall = expand.seconds
        self.stats["expansion_s"] = wall
        # the host share from the rounded device share, so that the two
        # add up to expansion_s at the three decimals they keep
        t_device = round(t_device, 3)
        self.stats["expansion_device_s"] = t_device
        self.stats["expansion_host_s"] = round(wall - t_device, 3)
        self.stats["expansion_refined"] = total_refined
        self.stats["expansion_pps"] = round(
            total_refined / max(wall, 1e-9), 2)
        self.stats["expansion_refine_host_s"] = round(
            tr.total("refine/enqueue") - host0, 3)
        self._log_graphs()
        return len(a.live_ids())

    def _autosave(self, path: str, inflight_parents=None) -> None:
        """One autosave: the checkpoint, with ``inflight_parents`` (popped,
        their children still in flight) written unexpanded, and the live
        snapshot."""
        a = self.arena
        with self.trace.span("autosave"):
            if inflight_parents is not None:
                a.expanded[inflight_parents] = False
            self.save_checkpoint(path)
            if inflight_parents is not None:
                a.expanded[inflight_parents] = True
            self._live_snapshot()

    def expand_distributed(self, mesh=None, max_rounds: int = 10_000,
                           per_shard: int = 256, refine_budget=None,
                           autosave_path: Optional[str] = None) -> int:
        """SPMD wavefront expansion over the ranks of a (patch, view) mesh
        (pais_mvs_tpu/engine/reconstructor.py:990-1191). Returns the live
        patch count.

        Each round orders the frontier by the configured expansion
        strategy, bins parents by reference-view cell column (slab
        ownership), and runs ``parallel.expansion.expand_step``: all-view
        candidate generation, the three-clause skipNeighborCell against
        the exchanged cellmate state, plane intersection, the refine,
        the insert-time re-check and the occupancy update; then merges
        the accepted patches into the arena. Parents whose candidates the
        refine budget deferred are re-queued, EXCEPT when the stall guard
        fires (two consecutive spill rounds with zero inserts: the
        occupancy cannot have changed), which drops that round's deferred
        candidates and logs it.

        Every rank of the mesh calls this and runs the same host loop on
        the same gathered results, so the arenas stay bit-identical and
        every exit test reads replicated values. ``mesh``: a
        ``parallel.mesh.Mesh``, or None for the Reconstructor's own mesh,
        else every rank of the world on the patch axis; a process with no
        process group runs in a world of one made for the call.

        ``stats["dist_device_s"]`` sums each round's ``expand_step``
        launch-to-completion span by CUDA events (the host clock on the
        CPU): it holds the device's idle gaps and the step's host syncs,
        so it bounds the device's busy time from above.
        ``stats["dist_refine_device_s"]`` is the part of it between the
        events around each step's refine; the rest is the step's own
        work and host syncs."""
        if mesh is None:
            mesh = self.mesh
        if mesh is not None:
            return self._expand_distributed(mesh, max_rounds, per_shard,
                                            refine_budget, autosave_path)
        with mesh_mod.world_mesh(self.device) as m:
            return self._expand_distributed(m, max_rounds, per_shard,
                                            refine_budget, autosave_path)

    def _expand_distributed(self, mesh, max_rounds, per_shard, refine_budget,
                            autosave_path) -> int:
        from pais_mvs_tpu_torch.parallel import expansion

        cfg = self.cfg
        a = self.arena
        dev = self.device
        S, k = mesh.patch.size, mesh.patch.index
        vp = mesh.view.size
        if refine_budget is None:
            refine_budget = 8 * per_shard
        cell = cfg.cell_size
        C_cams = a.num_cams
        cam_cells = np.stack(
            [np.asarray([math.ceil(w / cell) for w in self.widths], np.int32),
             np.asarray([math.ceil(h / cell) for h in self.heights],
                        np.int32)], axis=-1)                  # [C, 2]
        gw_cells = int(cam_cells[:, 0].max())
        gh_cells = int(cam_cells[:, 1].max())
        slab = max(1, math.ceil(gw_cells / S))
        scene = (self.scene if vp == 1
                 else self.scene.view_block(mesh.view.index, vp))

        # per-camera occupancy: counts AND cellmate state (center/normal/
        # correlation) for the correlation + isNeighbor skip clauses; this
        # rank keeps its slab of cell columns
        self._update_neighbor_radius()
        occ_np, ost_np = expansion.build_occupancy(
            a, cell, cam_cells, slab, S, gh_cells, cfg.max_cell_patch_num)
        mine = slice(k * slab, (k + 1) * slab)
        occ = torch.as_tensor(occ_np[mine], device=dev)
        ost = torch.as_tensor(ost_np[mine], device=dev)
        cam_cells_t = torch.as_tensor(cam_cells, device=dev)
        gen = self._patch_generator(k)
        refine_spans: list = []      # this round's: CUDA events or seconds

        def timed_refine(*args, **kw):
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            else:
                h0 = time.perf_counter()
            res = self._refine(*args, **kw)
            if cuda:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                refine_spans.append((e0, e1))
            else:
                refine_spans.append(time.perf_counter() - h0)
            return res

        on_dev = lambda x: torch.as_tensor(x, device=dev)
        cuda = dev.type == "cuda"

        t0 = time.time()
        total_spilled = total_refined = 0
        stall_rounds = rounds_run = 0
        t_device = t_refine = 0.0
        # per-parent record of candidates that already SPENT their one
        # refine in a spilled round (mvs.cpp:632-788), fed back as
        # ``cand_done``; only re-queued parents hold an entry, and the
        # checkpoint carries it, so a mid-expansion resume stays exact
        cand_done = self._dist_cand_done
        self._dist_save_time = a.count // self.autosave_interval
        for rnd in range(max_rounds):
            frontier = a.live_ids()
            frontier = frontier[~a.expanded[frontier]]
            if len(frontier) == 0:
                break
            order = self._strategy_order(frontier)
            ordered = frontier[order]                         # strategy order
            refc = a.data["ref_cam"][ordered].astype(np.int32)
            ipts = a.data["img_point"][ordered, refc]         # [N, 2]
            owner = np.clip((ipts[:, 0] / cell).astype(int) // slab, 0,
                            S - 1)

            # shard packing: rank of each parent within its shard (the
            # stable owner sort keeps the strategy order in each run)
            by_owner = np.argsort(owner, kind="stable")
            starts = np.searchsorted(owner[by_owner], np.arange(S))
            rank = np.arange(len(ordered)) - np.repeat(
                starts, np.diff(np.r_[starts, len(ordered)]))
            sel = by_owner[rank < per_shard]                  # kept rows
            slot = owner[sel] * per_shard + rank[rank < per_shard]

            N = S * per_shard
            centers = np.zeros((N, 3), np.float32)
            normals = np.zeros((N, 3), np.float32)
            orank = np.full(N, 1e30, np.float32)
            valid = np.zeros(N, bool)
            pmask = np.zeros((N, C_cams), bool)
            taken = ordered[sel]
            centers[slot] = a.data["center"][taken]
            normals[slot] = a.normals(taken)
            # the strategy-order position doubles as the device-side serial
            # rank; renumbered WITHIN the taken subset (values < S *
            # per_shard): the key cord = orank*(4C+1)+sub is float32, and
            # full-frontier positions would lose integer exactness past
            # 2^24/(4C+1) parents
            rank_in_taken = np.empty(len(sel), np.float32)
            rank_in_taken[np.argsort(sel, kind="stable")] = \
                np.arange(len(sel), dtype=np.float32)
            orank[slot] = rank_in_taken
            valid[slot] = True
            pmask[slot] = a.data["cam_mask"][taken]
            if len(taken) == 0:
                break
            a.expanded[taken] = True
            pdone = np.zeros((N, 4 * C_cams), bool)
            for j, pid in enumerate(taken):
                dm = cand_done.get(int(pid))
                if dm is not None:
                    pdone[slot[j]] = dm

            if cuda:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            else:
                h0 = time.perf_counter()
            out_pb, accepted, occ, ost, spilled, sp_par, ref_cand = \
                expansion.expand_step(
                    scene, cfg, on_dev(centers), on_dev(normals),
                    on_dev(orank), on_dev(valid), on_dev(pmask), occ, ost,
                    cam_cells_t, self.neighbor_radius, mesh, slab, gh_cells,
                    cap_per=cfg.max_cell_patch_num,
                    refine_budget=refine_budget, cand_done=on_dev(pdone),
                    generator=gen, refine=timed_refine)
            if cuda:
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
                ev1.synchronize()
                t_device += ev0.elapsed_time(ev1) / 1e3
                t_refine += sum(e0.elapsed_time(e1)
                                for e0, e1 in refine_spans) / 1e3
            else:
                t_device += time.perf_counter() - h0
                t_refine += sum(refine_spans)
            refine_spans.clear()
            rounds_run += 1
            acc = accepted.cpu().numpy()
            if acc.any():
                self._append_rows(out_pb.numpy(), np.nonzero(acc)[0],
                                  is_seed=False)
            rc = ref_cand.cpu().numpy()                       # [N, 4C]
            total_refined += int(rc.sum())
            n_spill = int(spilled[0])
            total_spilled += n_spill
            requeued = False
            requeue = np.empty(0, np.int64)
            if n_spill:
                # re-queue the parents of budget-deferred candidates (the
                # reference's queue never drops a candidate); after two
                # consecutive zero-insert spill rounds the occupancy cannot
                # change, and the stall guard DROPS the deferred candidates
                stall_rounds = stall_rounds + 1 if not acc.any() else 0
                if stall_rounds < 2:
                    sp = sp_par.cpu().numpy()                 # [N] by slot
                    requeue = taken[sp[slot]]
                    a.expanded[requeue] = False
                    requeued = True
            else:
                stall_rounds = 0
            # refine-exactly-once bookkeeping: re-queued parents accumulate
            # this round's consumed candidates; the others release theirs
            requeue_set = set(int(p) for p in requeue)
            for j, pid in enumerate(taken):
                pid = int(pid)
                if pid in requeue_set:
                    prev = cand_done.get(pid)
                    cand_done[pid] = (rc[slot[j]] if prev is None
                                      else prev | rc[slot[j]])
                else:
                    cand_done.pop(pid, None)
            fate = "re-queued" if requeued else "dropped (stall guard)"
            self._log(f"dist round {rnd}: {len(taken)} parents"
                      f" -> {int(acc.sum())} inserted"
                      f" (total {len(a.live_ids())})"
                      + (f" [refine-budget spill {n_spill}, {fate}]"
                         if n_spill else ""))
            if autosave_path and \
                    a.count // self.autosave_interval > self._dist_save_time:
                self._dist_save_time = a.count // self.autosave_interval
                self._autosave(autosave_path)
        else:
            # a round cap that leaves live unexpanded parents must be
            # LOUD, or a truncated cloud looks like a finished run
            left = a.live_ids()
            left = int((~a.expanded[left]).sum())
            if left:
                self._log(f"WARNING: expand_distributed stopped at the "
                          f"max_rounds={max_rounds} cap with {left} "
                          f"unexpanded frontier patches remaining — the "
                          f"cloud is truncated (raise max_rounds / "
                          f"per_shard to finish)")
        self.grids = None          # host grids rebuilt lazily for the filters
        wall = time.time() - t0
        self.stats["dist_expansion_s"] = wall
        self.stats["dist_device_s"] = round(t_device, 3)
        self.stats["dist_refine_device_s"] = round(t_refine, 3)
        self.stats["dist_rounds"] = rounds_run
        self.stats["dist_spilled"] = total_spilled
        self.stats["dist_refined"] = total_refined
        self.stats["dist_pps"] = round(total_refined / max(wall, 1e-9), 2)
        self._log_graphs()
        return len(a.live_ids())

    # ------------------------------------------------------------------
    # post filters (MVS::cellFiltering / visibilityFiltering /
    # neighborCellFiltering / neighborPatchFiltering, mvs.cpp:279-525)
    # ------------------------------------------------------------------
    def _ensure_grids(self):
        if self.grids is None:
            self._update_neighbor_radius()
            self.grids = self._grids_build()

    def _delete(self, pid: int):
        a = self.arena
        if self.grids is not None:
            self.grids.remove_patch(int(pid), a.data["cam_mask"][pid],
                                    a.data["img_point"][pid])
        a.delete(pid)

    def _native_kill(self, killed: np.ndarray) -> int:
        """Record natively-performed deletions (the C++ pass already
        removed them from the grid and flipped its alive copy)."""
        self.arena.delete(killed)
        return len(killed)

    def cell_filtering(self) -> int:
        """PMVS outlier rule: drop patch j in a cell when
        corr_j * camNum_j < sum of cellmates' correlations (mvs.cpp:279-325)."""
        self._ensure_grids()
        a = self.arena
        if self.use_native:
            n = a.count
            killed = self.grids.cell_filter(
                self.grids.all_keys(), a.data["correlation"][:n],
                a.data["cam_mask"][:n], a.data["img_point"][:n],
                a.alive[:n].astype(np.uint8))
            removed = self._native_kill(killed)
            self._log(f"cellFiltering removed {removed}")
            return removed
        removed = 0
        for key in self.grids.all_keys():
            occ = [p for p in self.grids.cell(*key) if a.alive[p]]
            if len(occ) < 2:
                continue
            corr = a.data["correlation"][occ]
            camn = a.data["cam_mask"][occ].sum(axis=1)
            tot = corr.sum()
            kill = [p for p, c, k in zip(occ, corr, camn)
                    if c * k < tot - c]
            for p in kill:
                self._delete(p)
                removed += 1
        self._log(f"cellFiltering removed {removed}")
        return removed

    def visibility_filtering(self) -> int:
        """Depth-ordering consistency per view (mvs.cpp:399-446)."""
        self._ensure_grids()
        a = self.arena
        cfg = self.cfg
        if self.use_native:
            n = a.count
            killed = self.grids.visibility_filter(
                a.live_ids(), a.data["center"][:n], self.np_center,
                a.data["cam_mask"][:n], a.data["img_point"][:n],
                a.alive[:n].astype(np.uint8), cfg.min_cam_num)
            removed = self._native_kill(killed)
            self._log(f"visibilityFiltering removed {removed}")
            return removed
        removed = 0
        for pid in a.live_ids():
            mask = a.data["cam_mask"][pid]
            ipts = a.data["img_point"][pid]
            center = a.data["center"][pid]
            cams = np.nonzero(mask)[0]
            visible = len(cams)
            for cam in cams:
                cam = int(cam)
                depth = np.linalg.norm(center - self.np_center[cam])
                cx, cy = self.grids.cell_of(ipts[cam])
                for q in self.grids.cell(cam, cx, cy):
                    if q == pid or not a.alive[q]:
                        continue
                    nd = np.linalg.norm(a.data["center"][q]
                                        - self.np_center[cam])
                    if depth > nd:
                        visible -= 1
                        break
            if visible < cfg.min_cam_num:
                self._delete(pid)
                removed += 1
        self._log(f"visibilityFiltering removed {removed}")
        return removed

    def neighbor_cell_filtering(self, neighbor_ratio: float) -> int:
        """3x3-cell neighbourhood support ratio (mvs.cpp:327-397)."""
        self._ensure_grids()
        a = self.arena
        if self.use_native:
            n = a.count
            killed = self.grids.neighbor_cell_filter(
                self.grids.all_keys(), a.data["center"][:n],
                a.data["normal_sph"][:n], a.data["cam_mask"][:n],
                a.data["img_point"][:n], a.alive[:n].astype(np.uint8),
                self.neighbor_radius, neighbor_ratio)
            removed = self._native_kill(killed)
            self._log(f"neighborCellFiltering removed {removed}")
            return removed
        removed = 0
        for key in self.grids.all_keys():
            cam, x, y = key
            occ = [p for p in self.grids.cell(*key) if a.alive[p]]
            kill = []
            for pid in occ:
                c1 = a.data["center"][pid]
                n1 = a.normals([pid])[0]
                nsum = 0
                nnum = 0
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        nx, ny = x + dx, y + dy
                        if not self.grids.in_map(cam, nx, ny):
                            continue
                        cell = [q for q in self.grids.cell(cam, nx, ny)
                                if a.alive[q]]
                        nsum += len(cell)
                        if cell:
                            c2 = a.data["center"][cell]
                            n2 = a.normals(cell)
                            nnum += int(self._is_neighbor(c1, n1, c2, n2)
                                        .sum())
                if nsum and nnum / nsum < neighbor_ratio:
                    kill.append(pid)
            for p in kill:
                self._delete(p)
                removed += 1
        self._log(f"neighborCellFiltering removed {removed}")
        return removed

    def neighbor_patch_filtering(self, neighbor_ratio: float) -> int:
        """PCMVS density rule: drop patches with fewer Euclidean neighbours
        (within neighborRadius) than avg * ratio (mvs.cpp:448-525).
        Implemented as chunked pairwise distances (the reference is an
        O(N^2) OMP loop)."""
        self._ensure_grids()
        a = self.arena
        ids = a.live_ids()
        if len(ids) == 0:
            return 0
        if self.use_native:
            counts = native_rt.neighbor_counts(a.data["center"], ids,
                                               self.neighbor_radius)
        else:
            centers = a.data["center"][ids]
            N = len(ids)
            counts = np.zeros(N, dtype=np.int64)
            chunk = max(1, int(2e7 / max(N, 1)))
            for s in range(0, N, chunk):
                d = np.linalg.norm(centers[s:s + chunk, None, :]
                                   - centers[None, :, :], axis=-1)
                counts[s:s + chunk] = \
                    (d <= self.neighbor_radius).sum(axis=1) - 1
        avg = counts.mean()
        kill = ids[counts < avg * neighbor_ratio]
        for p in kill:
            self._delete(p)
        self._log(f"neighborPatchFiltering removed {len(kill)} "
                  f"(avg neighbours {avg:.2f})")
        return len(kill)

    def run_filters(self, ratio: float = 0.25) -> None:
        """The reference ``-f`` pipeline (TMVS.cpp:124-172)."""
        self.cell_filtering()
        self.visibility_filtering()
        self.neighbor_cell_filtering(ratio)
        self.arena.deleted_ids.clear()
        self.neighbor_patch_filtering(ratio)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def patch_data(self, deleted: bool = False) -> MvsPatchData:
        a = self.arena
        if deleted:
            ids = np.asarray(a.deleted_ids, dtype=np.int64)
        else:
            ids = a.live_ids()
        return MvsPatchData(
            centers=a.data["center"][ids],
            normal_sph=a.data["normal_sph"][ids],
            cam_masks=a.data["cam_mask"][ids],
            fitness=a.data["fitness"][ids],
            correlation=a.data["correlation"][ids])

    def live_centers(self) -> np.ndarray:
        return self.arena.data["center"][self.arena.live_ids()]

    def write_mvs(self, path: str, deleted: bool = False) -> None:
        write_mvs(path, self.cfg, self.params, self.patch_data(deleted))

    # ------------------------------------------------------------------
    # checkpoint / resume (SURVEY §5.4): the .mvs is the reference's
    # checkpoint but cannot carry the expansion frontier — the reference
    # restarts expansion ordering from scratch on resume. The sidecar
    # .state.npz captures the FULL arena (expanded flags, deleted archive,
    # neighborRadius), so resume continues exactly where the run stopped.
    # The format is the JAX package's (``np.savez_compressed``'s zip, here
    # deflated block by block across the host's cores, ``io/npz.py``):
    # either engine resumes the other's.
    # ------------------------------------------------------------------
    def save_checkpoint(self, mvs_path: str) -> None:
        tr = self.trace
        with tr.span("autosave/mvs"):
            self.write_mvs(mvs_path)
        a = self.arena
        n = a.count
        state = {f"d_{k}": v[:n] for k, v in a.data.items()}
        cd = self._dist_cand_done
        if cd:
            ids = sorted(cd.keys())
            state["cand_done_ids"] = np.asarray(ids, np.int64)
            state["cand_done_masks"] = np.stack([cd[i] for i in ids])
        # write-then-rename: a crash mid-save must never leave a truncated
        # sidecar that poisons the next resume
        tmp = mvs_path + f".state.npz.{os.getpid()}.tmp"
        with tr.span("autosave/sidecar"):
            with open(tmp, "wb") as fh:
                raw, blocks = npz.savez_deflated(
                    fh, count=np.asarray(n), alive=a.alive[:n],
                    expanded=a.expanded[:n],
                    deleted_ids=np.asarray(a.deleted_ids, dtype=np.int64),
                    neighbor_radius=np.asarray(self.neighbor_radius),
                    **state)
            os.replace(tmp, mvs_path + ".state.npz")
        tr.count("autosaves")
        tr.count("autosave_bytes", os.path.getsize(mvs_path)
                 + os.path.getsize(mvs_path + ".state.npz"))
        tr.count("sidecar_raw_bytes", raw)
        tr.count("deflate_blocks", blocks)
        tr.set("deflate_threads", npz.threads())

    def load_checkpoint(self, mvs_path: str) -> bool:
        """Restore the arena from ``mvs_path + '.state.npz'`` if present and
        readable. Returns True when resumed (the .mvs itself is then
        redundant); a corrupt sidecar is reported and ignored so the caller
        falls back to the .mvs patches."""
        path = mvs_path + ".state.npz"
        if not os.path.exists(path):
            return False
        a = self.arena
        # materialize EVERY array inside the try: a sidecar that opens but
        # has a truncated/corrupt member must not leave the arena
        # half-mutated (the fallback-to-.mvs contract)
        try:
            st = np.load(path)
            n = int(st["count"])
            fields = {k: np.asarray(st[f"d_{k}"]) for k in a.data}
            alive = np.asarray(st["alive"])
            expanded = np.asarray(st["expanded"])
            deleted_ids = [int(i) for i in st["deleted_ids"]]
            neighbor_radius = float(st["neighbor_radius"])
            if "cand_done_ids" in st.files:
                cand_done = {int(i): np.asarray(m) for i, m in
                             zip(st["cand_done_ids"],
                                 st["cand_done_masks"])}
            else:
                cand_done = {}
            for k, v in fields.items():
                if v.shape[0] != n:
                    raise ValueError(f"field {k} has {v.shape[0]} rows, "
                                     f"expected {n}")
            if alive.shape[0] != n or expanded.shape[0] != n:
                raise ValueError("alive/expanded length mismatch")
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            if self.logger is not None:
                self.logger.warning(f"ignoring corrupt checkpoint sidecar "
                                    f"{path}: {e}")
            return False
        a._grow(max(n, 1))
        a.count = n
        for k in a.data:
            a.data[k][:n] = fields[k]
        a.alive[:n] = alive
        a.expanded[:n] = expanded
        a.deleted_ids = deleted_ids
        self.neighbor_radius = neighbor_radius
        self._dist_cand_done = cand_done
        self.grids = None
        self._log(f"resumed checkpoint {path}: {n} patches "
                  f"({int(a.alive[:n].sum())} live, "
                  f"{int((~a.expanded[:n] & a.alive[:n]).sum())} frontier)")
        return True

    def _live_snapshot(self) -> None:
        """Offline analog of the reference's live-viewer hook
        ``addPatchView`` (TMVS/mvs/mvs.h:12, TMVS.cpp:20-24): when
        ``live_snapshot_dir`` is set (CLI ``--live-snapshots``), each
        autosave also refreshes ``live_snapshot.ply`` with the current
        cloud, so a long reconstruction can be watched mid-flight."""
        if not self.live_snapshot_dir:
            return
        tmp = os.path.join(self.live_snapshot_dir, ".live_snapshot.tmp")
        dst = os.path.join(self.live_snapshot_dir, "live_snapshot.ply")
        with self.trace.span("autosave/snapshot"):
            self.write_ply(tmp)
            os.replace(tmp, dst)   # atomic: a watcher never sees a torn file

    def write_ply(self, path: str, deleted: bool = False) -> None:
        a = self.arena
        ids = (np.asarray(a.deleted_ids, dtype=np.int64) if deleted
               else a.live_ids())
        write_ply(path, a.data["center"][ids], a.normals(ids),
                  a.data["color"][ids])

    def write_psr(self, path: str) -> None:
        ids = self.arena.live_ids()
        write_psr(path, self.arena.data["center"][ids],
                  self.arena.normals(ids))
