"""Full-semantics SPMD wavefront expansion over the (patch, view) layout.

The counterpart of ``pais_mvs_tpu/parallel/expansion.py``, with the same
names. There one ``shard_map`` runs the round on every device; here every
rank runs ``expand_step`` on its own rows and the collectives of
``parallel/mesh.py`` join them (``all_gather(tiled=True)`` ->
``mesh.patch.all_gather``, ``psum`` -> ``mesh.patch.psum``,
``axis_index`` -> ``mesh.patch.index``). The semantics are the JAX
module's:

  * candidates come from EVERY visible view's cell grid, the reference's
    expandNeighborCell loop (TMVS/mvs/mvs.cpp:529-564);
  * skipNeighborCell applies ALL THREE clauses (mvs.cpp:792-807) against
    an [grid_w, C*grid_h] count grid and an [grid_w, C*grid_h, cap, 7]
    cellmate-state grid, both split over cell columns: each patch rank
    holds one slab of ``slab_cols`` columns;
  * the serial ordering of the reference's priority queue (mvs.cpp:632-788)
    is an explicit per-parent ORDER RANK, and every cell-budget decision
    (per-cell intra-round cap, refine-budget compaction, insert-time
    re-check) is taken in that order;
  * candidates are all-gathered and each rank keeps the rows whose
    (camera, cell column) slab it owns;
  * ``insert_fixpoint`` replays the host's serial insert loop exactly
    (a Jacobi join iterated until nothing changes);
  * candidates past the refine budget are reported through
    ``spilled_parents`` for re-queueing, and ``refined_cands`` records
    which ones spent their refine, so a re-queued parent never refines
    them again (refine-exactly-once).

Every rank passes the whole round's inputs (the host loop is replicated)
and gets back the whole refined batch, the replicated verdicts and its own
occupancy slab; nothing here branches on a rank's own data, so the ranks
make the same collective calls. With a view axis (vp > 1) the refine runs
view-sharded on the rank's camera block (``Scene.view_block``); everything
else is rig and occupancy math, the same on every view rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.models import patch as patch_mod
from pais_mvs_tpu_torch.ops import geometry as geom
from pais_mvs_tpu_torch.ops import lifecycle as lc
from pais_mvs_tpu_torch.ops.pso import PsoDraws

OCC_STATE_F = 7            # center xyz, normal xyz, correlation
BIGCELL = 2 ** 30
_OFFSETS = ((-1, 0), (0, -1), (1, 0), (0, 1))
_BATCH_FIELDS = tuple(f.name for f in dataclasses.fields(
    patch_mod.PatchBatch))


def _run_rank(sort_key_cells: torch.Tensor, order_idx: torch.Tensor
              ) -> torch.Tensor:
    """Rank of each element within its (sorted) equal-cell run.

    sort_key_cells: [M] cell ids with inactive rows pushed to a sentinel;
    order_idx: [M] f32 serial-order key (lower = earlier). Returns rank
    [M] in ORIGINAL row order. ``jnp.lexsort`` is stable: two stable sorts,
    the minor key first."""
    o1 = torch.sort(order_idx, stable=True).indices
    o2 = torch.sort(sort_key_cells[o1], stable=True).indices
    order = o1[o2]
    cid_s = sort_key_cells[order]
    idx = torch.arange(cid_s.shape[0], device=cid_s.device)
    same = torch.zeros_like(cid_s, dtype=torch.bool)
    same[1:] = cid_s[1:] == cid_s[:-1]
    start = torch.cummax(torch.where(same, 0, idx), 0).values
    return torch.empty_like(idx).scatter_(0, order, idx - start)


def _skip_clauses(occ, ost, lcol, comb, pcen, pnorm, nr, cap: int,
                  min_correlation: float):
    """MVS::skipNeighborCell (mvs.cpp:792-807) against the local occupancy
    state: returns (skip [M] bool, cnt [M] i32). Clause a: cell full;
    clause b: any cellmate correlation > minCorrelation; clause c: any
    cellmate within plane-to-plane neighbor distance of the parent."""
    cnt = occ[lcol, comb]                                     # [M]
    st = ost[lcol, comb]                                      # [M, cap, 7]
    slot_ok = (torch.arange(cap, device=cnt.device)[None, :]
               < torch.clamp(cnt, max=cap)[:, None])          # [M, cap]
    skip = cnt >= cap
    skip |= torch.any(slot_ok & (st[..., 6] > min_correlation), -1)
    d = st[..., 0:3] - pcen[:, None, :]
    dist = torch.abs(torch.sum(d * pnorm[:, None, :], -1)) + \
        torch.abs(torch.sum(d * st[..., 3:6], -1))
    skip |= torch.any(slot_ok & (dist <= nr), -1)
    return skip, cnt


def insert_fixpoint(a_acc, a_vis, a_cm, a_ord, a_st, a_ocell, a_cnt0,
                    a_pc, a_pn, a_cx, a_cy, cnt_vis, C: int, grid_h: int,
                    cap: int, min_correlation: float, nr) -> torch.Tensor:
    """EXACT replicated mirror of the host's serial insert loop (per-
    candidate live-grid ``_insert_time_cell_filter`` + ``_skip_neighbor_
    cell`` re-check, in strategy order, cells filling as earlier
    candidates insert); ``pais_mvs_tpu/parallel/expansion.py:117-215``.

    Inputs are per-candidate rows of the whole round ([SR] unless noted):
    a_acc refine-acceptance, a_vis [SR, C] visible & in-frame per refined
    view, a_cm [SR, C] the refined cam_mask (the density denominator),
    a_ord unique f32 serial-order keys, a_st [SR, 7] refined (center,
    normal, correlation), a_ocell original candidate-cell ids, a_cnt0
    pre-round occupant count of that cell, a_pc/a_pn [SR, 3] the PARENT
    plane, a_cx/a_cy [SR, C] refined cell coords, cnt_vis [SR, C]
    pre-round occupant counts of the refined cells. Returns the accepted
    mask [SR].

    A candidate's verdict depends only on strictly earlier-order verdicts,
    so the serial answer is the unique fixpoint of the synchronous
    re-check: the join is iterated until nothing changes, at most SR + 1
    trips (one host sync each); reaching that cap raises."""
    dev = a_ord.device
    SR = a_ord.shape[0]
    E = SR * C
    TOT = E + SR + E
    vis_cell = torch.where(
        a_vis, (a_cx * C + torch.arange(C, device=dev)[None, :]) * grid_h
        + a_cy, BIGCELL)                                      # [SR, C]
    # entry table: [0:E) insert entries (keys masked by the acceptance
    # estimate inside the loop), [E:E+SR) candidate original-cell probes,
    # [E+SR:) candidate visible-cell probes
    tag_all = torch.cat([torch.zeros(E, dtype=torch.int32, device=dev),
                         torch.ones(SR + E, dtype=torch.int32, device=dev)])
    ord_ins = torch.repeat_interleave(a_ord, C)
    ord_all = torch.cat([ord_ins, a_ord, ord_ins])
    key_cand = torch.cat([a_ocell, vis_cell.reshape(-1)])
    st_ins = torch.repeat_interleave(a_st, C, 0)              # [E, 7]
    cand_ord = torch.cat([a_ord, ord_ins])
    pc_cand = torch.cat([a_pc, torch.repeat_interleave(a_pc, C, 0)])
    pn_cand = torch.cat([a_pn, torch.repeat_interleave(a_pn, C, 0)])
    nvis = torch.sum(a_cm, -1)
    idx = torch.arange(TOT, device=dev)
    # the keys that do not change across trips: lexsort's minor keys
    o_ord = torch.sort(ord_all, stable=True).indices
    o_tag = o_ord[torch.sort(tag_all[o_ord], stable=True).indices]

    def join_pass(acc_est):
        ins_key = torch.where((a_vis & acc_est[:, None]).reshape(-1),
                              vis_cell.reshape(-1), BIGCELL)
        key_all = torch.cat([ins_key, key_cand])
        s_idx = o_tag[torch.sort(key_all[o_tag], stable=True).indices]
        key_s = key_all[s_idx]
        same = torch.zeros(TOT, dtype=torch.bool, device=dev)
        same[1:] = key_s[1:] == key_s[:-1]
        start = torch.cummax(torch.where(same, 0, idx), 0).values
        inv = torch.empty_like(s_idx).scatter_(0, s_idx, idx)
        own_start = start[inv[E:]]                            # [SR + E]
        blocked = torch.zeros(SR + E, dtype=torch.bool, device=dev)
        n_before = torch.zeros(SR + E, dtype=torch.int32, device=dev)
        for j in range(cap):
            e = torch.clamp(own_start + j, 0, TOT - 1)
            se = s_idx[e]
            is_ins = (se < E) & (key_all[se] == key_cand) \
                & (ord_all[se] < cand_ord)
            n_before += is_ins.to(torch.int32)
            st_e = st_ins[torch.clamp(se, 0, E - 1)]
            corr_hit = st_e[:, 6] > min_correlation
            d = st_e[:, 0:3] - pc_cand
            nb_hit = (torch.abs(torch.sum(d * pn_cand, -1))
                      + torch.abs(torch.sum(d * st_e[:, 3:6], -1))) <= nr
            blocked |= is_ins & (corr_hit | nb_hit)
        # original-cell skip re-check: live count + clauses b/c
        bad = blocked[:SR] | (a_cnt0 + n_before[:SR] >= cap)
        # all-views density vote against the LIVE refined-cell counts
        n_vis_ins = n_before[SR:].reshape(SR, C)
        full = a_vis & (cnt_vis + n_vis_ins >= cap)
        dens_ok = (torch.sum(full, -1) < nvis) | (nvis == 0)
        return a_acc & dens_ok & ~bad

    acc = a_acc
    for _ in range(SR + 1):
        nxt = join_pass(acc)
        if torch.equal(nxt, acc):
            return nxt
        acc = nxt
    raise RuntimeError(f"insert_fixpoint: the join did not settle in "
                       f"{SR + 1} trips")


def expand_step(scene, cfg: MvsConfig, centers, normals, order_rank, valid,
                parent_cam_mask, occ_cnt, occ_state, cam_cells,
                neighbor_radius, mesh, slab_cols: int, grid_h: int,
                cap_per: int, refine_budget: int, cand_done=None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[PsoDraws] = None):
    """One COMPLETE distributed expansion round (see module docstring);
    ``pais_mvs_tpu/parallel/expansion.py:218-499``.

    Whole-round inputs, the same on every rank: centers/normals [N, 3],
    order_rank [N] f32 strategy-order positions, valid [N],
    parent_cam_mask [N, C], cam_cells [C, 2] i32 per-camera grid (w, h)
    in cells, cand_done [N, 4*C] bool (optional, default all-False; the
    candidates each parent has already spent a refine on, indexed
    cam*4 + offset). Patch rank k works on parent rows [k*N/S, (k+1)*N/S)
    (N divisible by the patch axis S). This rank's occupancy slab:
    occ_cnt [slab_cols, C*grid_h] i32 and occ_state [slab_cols, C*grid_h,
    cap_per, 7] f32, cell columns [k*slab_cols, (k+1)*slab_cols).
    ``scene`` is this rank's camera block when the view axis has more
    than one rank. PSO: ``draws`` (one PsoDraws for the round's whole
    refined batch, S*refine_budget rows, patch rank k's rows from
    k*refine_budget on) when given, else ``generator``, which must be
    seeded from the patch index alone.

    Returns (refined PatchBatch [S*refine_budget rows, every rank's],
    accepted [S*refine_budget] bool, this rank's new occ_cnt and
    occ_state slabs, spilled [1] i32 — candidates deferred by the refine
    budget, spilled_parents [N] bool — parent slots to re-queue,
    refined_cands [N, 4*C] bool — the candidates that consumed their
    refine this round)."""
    rig = scene.rig
    dev = centers.device
    C = rig.num_cameras
    vp = mesh.view.size
    if C % vp:
        raise ValueError(f"view axis {vp} must divide the camera count {C}")
    patch = mesh.patch
    k, S = patch.index, patch.size
    N = centers.shape[0]
    if N % S:
        raise ValueError(f"{N} parent slots do not split over the patch "
                         f"axis of size {S}")
    n = N // S
    if cand_done is None:
        cand_done = torch.zeros((N, 4 * C), dtype=torch.bool, device=dev)
    rows = slice(k * n, (k + 1) * n)
    pc, pn, orank = centers[rows], normals[rows], order_rank[rows]
    pval, pmask, pdone = valid[rows], parent_cam_mask[rows], cand_done[rows]
    occ, ost = occ_cnt, occ_state
    cap = cap_per
    cell_size = cfg.cell_size
    CGH = C * grid_h
    i32 = torch.int32
    ar = lambda m: torch.arange(m, device=dev)

    # ---- candidate generation: 4-neighbour cells in EVERY visible
    # view's grid (mvs.cpp:529-564) ----
    ipts = geom.project(pc[:, None, :], rig.R, rig.T, rig.focal,
                        rig.principal)[0]                     # [n, C, 2]
    ipts = torch.where(torch.isfinite(ipts), ipts, -1e6)
    cx = torch.floor(ipts[..., 0] / cell_size).to(i32)
    cy = torch.floor(ipts[..., 1] / cell_size).to(i32)
    offs = torch.tensor(_OFFSETS, dtype=i32, device=dev)
    ncx = cx[:, :, None] + offs[None, None, :, 0]             # [n, C, 4]
    ncy = cy[:, :, None] + offs[None, None, :, 1]
    wcell = cam_cells[None, :, 0:1]                           # [1, C, 1]
    hcell = cam_cells[None, :, 1:2]
    ok = (pval[:, None, None] & pmask[:, :, None]
          & (ncx >= 0) & (ncx < wcell) & (ncy >= 0) & (ncy < hcell))
    # refine-exactly-once: candidates this parent already spent a refine
    # on (in a spilled earlier round) are consumed
    ok &= ~pdone.reshape(n, C, 4)

    m = n * C * 4
    cam = ar(C)[None, :, None].expand(n, C, 4)
    parf = ar(n)[:, None, None].expand(n, C, 4).reshape(-1)
    # candidate-granular serial order: parent strategy rank, then the
    # reference's cam-outer offset-inner generation order within the
    # parent (mvs.cpp:535-549)
    sub = (cam * 4 + ar(4)[None, None, :]).to(torch.float32)
    cord = orank[parf] * (4 * C + 1) + sub.reshape(-1)
    payload = torch.cat([
        pc[parf], pn[parf],                                   # 0:3, 3:6
        cord[:, None],                                        # 6
        cam.reshape(-1, 1).to(torch.float32),                 # 7
        pmask[parf].to(torch.float32),                        # 8:8+C
    ], -1)                                                    # [m, 8+C]

    # ---- route: all_gather, keep owned rows ----
    g_pay, g_cr, g_ok = patch.all_gather_rows(
        [payload, torch.stack([ncx.reshape(-1), ncy.reshape(-1)], -1),
         ok.reshape(-1)])                                     # [S*m, ...]
    g_col, g_row = g_cr[:, 0], g_cr[:, 1]
    owner = torch.clamp(torch.div(g_col, slab_cols, rounding_mode="floor"),
                        0, S - 1)
    mine = g_ok & (owner == k)
    lcol = torch.clamp(g_col - k * slab_cols, 0, slab_cols - 1)
    camg = g_pay[:, 7].to(i32)
    comb = torch.clamp(camg * grid_h + g_row, 0, CGH - 1)

    # ---- skipNeighborCell, all three clauses ----
    skip, cnt_g = _skip_clauses(occ, ost, lcol, comb, g_pay[:, 0:3],
                                g_pay[:, 3:6], neighbor_radius, cap,
                                float(cfg.min_correlation))
    mine &= ~skip

    # ---- intra-round per-cell budget in strategy order ----
    g_ord = g_pay[:, 6]
    cell_id = torch.where(mine, lcol * CGH + comb, BIGCELL)
    rank = _run_rank(cell_id, g_ord)
    mine &= rank + cnt_g < cap

    # ---- compact to the per-shard refine budget, strategy order ----
    G = g_ord.shape[0]
    sel = torch.sort(torch.where(mine, g_ord, torch.inf),
                     stable=True).indices[:refine_budget]
    R = sel.shape[0]
    keep = mine[sel]
    kept_mask = torch.zeros(G, dtype=torch.bool, device=dev)
    kept_mask[sel] = keep
    # gathered row r belongs to parent slot (r // m) * n + (r % m) // (4C);
    # each candidate is owned by exactly one rank, so the psums are exact
    ridx = ar(G)
    gslot = (ridx // m) * n + (ridx % m) // (4 * C)
    subi = (ridx % m) % (4 * C)
    sp_par = torch.zeros(S * n, dtype=i32, device=dev).index_put_(
        (gslot,), (mine & ~kept_mask).to(i32), accumulate=True)
    ref_cand = torch.zeros(S * n * 4 * C, dtype=i32, device=dev).index_put_(
        (gslot * (4 * C) + subi,), kept_mask.to(i32), accumulate=True)
    spilled = (torch.sum(mine) - torch.sum(keep)).to(i32).reshape(1)
    # one psum for the three counts
    red = patch.psum(torch.cat([spilled, sp_par, ref_cand]))
    spilled = red[:1]
    sp_par = red[1:1 + S * n] > 0
    ref_cand = (red[1 + S * n:] > 0).reshape(S * n, 4 * C)
    rpay = g_pay[sel]
    rcol = g_col[sel]
    rrow = g_row[sel]
    rcnt0 = cnt_g[sel]             # pre-round count at the target cell
    rcam = rpay[:, 7].to(torch.long)

    # ---- candidate center: cell-center ray of the CANDIDATE'S view
    # meeting the parent plane (mvs.cpp:809-836) ----
    px = (rcol.to(torch.float32) + 0.5) * cell_size
    py = (rrow.to(torch.float32) + 0.5) * cell_size
    dirs = geom.pixel_to_world_dir(torch.stack([px, py], -1), rig.R[rcam],
                                   rig.center[rcam], rig.focal[rcam],
                                   rig.principal[rcam])
    new_center = geom.ray_plane_intersect(rig.center[rcam], dirs,
                                          rpay[:, 0:3], rpay[:, 3:6])

    # ---- viewing-cone camera set with the parent-mask fallback
    # (patch.cpp:723-761) ----
    facing = -(rpay[:, None, 3:6] * rig.optical[None]).sum(-1)  # [R, C]
    mask = facing >= cfg.visible_correlation
    lacking = torch.sum(mask, -1) < cfg.min_cam_num
    fallback = (rpay[:, 8:8 + C] > 0.5) & \
        (facing >= cfg.visible_correlation / 2.0)
    mask = torch.where(lacking[:, None], mask | fallback, mask)

    pb = patch_mod.empty_batch(R, C, dev).replace(
        center=new_center.to(torch.float32),
        normal_sph=geom.normal_to_spherical(rpay[:, 3:6]).to(torch.float32),
        cam_mask=mask,
        valid=keep & torch.all(torch.isfinite(new_center), -1)
        & (torch.sum(mask, -1) >= cfg.min_cam_num))
    # the kept candidates are a prefix of ``sel``: the PSO runs on the
    # longest prefix of any patch rank (the same on every rank); the rest,
    # none of them valid, take refine_batch's bookkeeping alone (rounds=0),
    # which is what one round leaves on an invalid row
    view = mesh.view if vp > 1 else None
    n_run = max(int(patch.all_gather(keep.sum().reshape(1), 0).max()), 1)
    head = patch_mod.take(pb, ar(n_run))
    rb = lc.refine_batch(
        scene, cfg, head, neighbor_radius, False, 1,
        generator=None if draws is not None else generator,
        draws=None if draws is None else [PsoDraws(
            draws.pos[k * R:k * R + n_run], draws.vel[k * R:k * R + n_run],
            draws.steps[:, :, k * R:k * R + n_run])], view=view).batch
    if n_run < R:
        tail = lc.refine_batch(scene, cfg, patch_mod.take(pb, ar(R)[n_run:]),
                               neighbor_radius, False, 0, view=view).batch
        rb = patch_mod.concat(rb, tail)
    acc0 = rb.valid

    # ---- insert-time re-check on the REFINED patches: density across
    # every visible view's refined cell + intra-round ref-cell budget, in
    # strategy order ----
    nipts = geom.project(rb.center[:, None, :], rig.R, rig.T, rig.focal,
                         rig.principal)[0]                    # [R, C, 2]
    nipts = torch.where(torch.isfinite(nipts), nipts, -1e6)
    ncx2 = torch.floor(nipts[..., 0] / cell_size).to(i32)
    ncy2 = torch.floor(nipts[..., 1] / cell_size).to(i32)
    inm = (ncx2 >= 0) & (ncx2 < cam_cells[None, :, 0]) & \
          (ncy2 >= 0) & (ncy2 < cam_cells[None, :, 1])
    vis2 = rb.cam_mask & inm                                  # [R, C]

    # the (small) per-row insert metadata and the refined batch to every
    # rank: one gather per dtype
    normal_new = geom.spherical_to_normal(rb.normal_sph)
    st_new = torch.cat([rb.center, normal_new, rb.correlation[:, None]], -1)
    ocell = (rcol * C + rcam.to(i32)) * grid_h + rrow         # orig cand cell
    fields = [getattr(rb, f) for f in _BATCH_FIELDS]
    meta = [ncx2, ncy2, vis2, rpay[:, 6], st_new, ocell, rcnt0,
            rpay[:, 0:3], rpay[:, 3:6]]
    got = patch.all_gather_rows(fields + meta)
    out_pb = rb.replace(**dict(zip(_BATCH_FIELDS, got)))
    (a_cx, a_cy, a_vis, a_ord, a_st, a_ocell, a_cnt0, a_pc,
     a_pn) = got[len(fields):]
    a_cm, a_acc = out_pb.cam_mask, out_pb.valid

    # pre-round occupant counts of every visible refined cell: each rank
    # reads the cells it owns, one psum replicates the table
    own2 = (torch.clamp(torch.div(a_cx, slab_cols, rounding_mode="floor"),
                        0, S - 1) == k) & a_vis
    lcol2 = torch.clamp(a_cx - k * slab_cols, 0, slab_cols - 1)
    comb2 = torch.clamp(ar(C)[None, :] * grid_h + a_cy, 0, CGH - 1)
    cnt_vis = patch.psum(torch.where(own2, occ[lcol2, comb2], 0))

    # EXACT serial-insert mirror (replicated: identical verdicts on every
    # rank). No extra budget gate on the refined reference cell: the cap
    # gates candidates, not storage.
    acc_all = insert_fixpoint(
        a_acc, a_vis, a_cm, a_ord, a_st, a_ocell, a_cnt0, a_pc, a_pn,
        a_cx, a_cy, cnt_vis, C, grid_h, cap, float(cfg.min_correlation),
        neighbor_radius)                                      # [S*R]

    # ---- occupancy update: register every accepted patch in EVERY
    # visible view's cell (CellMap::insert semantics) ----
    updf = (own2 & acc_all[:, None]).reshape(-1)              # [S*R*C]
    lcolf = lcol2.reshape(-1)
    combf = comb2.reshape(-1)
    cellf = torch.where(updf, lcolf * CGH + combf, BIGCELL)
    ordf = torch.repeat_interleave(a_ord, C)
    rankf = _run_rank(cellf, ordf)
    slot = occ[lcolf, combf] + rankf
    put = updf & (slot < cap)         # occupants past the cap are dropped
    ost2 = ost.clone()
    ost2[lcolf[put], combf[put], slot[put].long()] = \
        torch.repeat_interleave(a_st, C, 0)[put]
    occ2 = occ.clone().index_put_((lcolf, combf), updf.to(occ.dtype),
                                  accumulate=True)
    return out_pb, acc_all, occ2, ost2, spilled, sp_par, ref_cand


def build_occupancy(arena, cell_size: int, cam_cells: np.ndarray,
                    slab_cols: int, S: int, grid_h: int, cap: int):
    """Host-side occupancy (count + state) grids from the live arena,
    registering each patch in EVERY visible view's cell like the
    reference's per-camera CellMaps (mvs.cpp:74-87). Vectorized numpy; a
    copy of ``pais_mvs_tpu/parallel/expansion.py:502-543``.

    Returns (occ_cnt [S*slab_cols, C*grid_h] i32,
             occ_state [S*slab_cols, C*grid_h, cap, 7] f32)."""
    C = cam_cells.shape[0]
    grid_w = S * slab_cols
    CGH = C * grid_h
    occ = np.zeros((grid_w, CGH), np.int32)
    ost = np.zeros((grid_w, CGH, cap, OCC_STATE_F), np.float32)
    ids = arena.live_ids()
    if len(ids) == 0:
        return occ, ost
    cm = arena.data["cam_mask"][ids]                          # [L, C]
    ip = arena.data["img_point"][ids]                         # [L, C, 2]
    i_idx, c_idx = np.nonzero(cm)
    cx = np.floor(ip[i_idx, c_idx, 0] / cell_size).astype(np.int64)
    cy = np.floor(ip[i_idx, c_idx, 1] / cell_size).astype(np.int64)
    inb = ((cx >= 0) & (cx < np.minimum(cam_cells[c_idx, 0], grid_w)) &
           (cy >= 0) & (cy < cam_cells[c_idx, 1]))
    i_idx, c_idx, cx, cy = i_idx[inb], c_idx[inb], cx[inb], cy[inb]
    comb = c_idx * grid_h + cy
    np.add.at(occ, (cx, comb), 1)
    # state slots: rank within each cell (stable insertion order by
    # arena id, like the reference's push_back)
    lin = cx * CGH + comb
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    starts = np.r_[0, np.nonzero(lin_s[1:] != lin_s[:-1])[0] + 1]
    rank = np.arange(len(lin_s)) - np.repeat(
        starts, np.diff(np.r_[starts, len(lin_s)]))
    sel = rank < cap
    rows = order[sel]
    ctr = arena.data["center"][ids]
    nrm = arena.normals(ids)
    corr = arena.data["correlation"][ids]
    st = np.concatenate([ctr, nrm, corr[:, None]], -1).astype(np.float32)
    ost[cx[rows], comb[rows], rank[sel]] = st[i_idx[rows]]
    return occ, ost
