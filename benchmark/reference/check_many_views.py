"""``check.py``'s comparison for a rig on which a patch sees tens of
cameras out of hundreds (the Middlebury temple's hemisphere): the same
numbers, judged by the same plain reference (``photo.py``'s ``RefScene``)
and the same rules (``check.py``'s ``judge``, ``sensitivity`` and
``best_per_patch``, imported), over fewer admissible states.

The program scored a written patch's fitness and correlation in its last
refine round, with the reference camera, camera set and level that the
patch had before that round's PSO. ``check.states`` tries every camera of
the written set as the reference and every one-camera addition from the
whole rig: at about 90 visible cameras of 312 that is some 60,000 states a
patch, beyond any run. Here the states are bounded to what that round can
have held. An expansion patch entered its only round with the cameras
that the expansion rule (Patch::expandVisibleCamera) gives its parent's
normal: those whose optical axis it faces within visibleCorrelation, or,
below minCamNum of them, the parent's own cameras within half of that;
with the best of them by normal . (-optical axis) under that normal as
its reference; and at the point where the ray through the centre of a
cell next to the parent's own, in one of the parent's views, meets the
parent's plane (MVS::getExpansionPatchCenter). Its refine moved it along
the line from that reference camera only (the PSO's depth), and a -r job
neither deletes nor refines a parent again, so the cloud holds the parent
as it expanded. A seed entered its last round with its set of the round
before, so with the written set and the cameras that round dropped. The
admissible states of a patch are then:

  * for each of its NEIGHBOURS nearest patches of the cloud that passes
    the parent test (``parents``: the line from the reference camera of
    that patch's expansion set through this patch's centre meets that
    patch's plane within CELL_CENTRE_PX of the centre of a cell next to
    its own, in one of its views), that expansion set and reference;
  * the written set S with one of its TOP_REFS best cameras under the
    written normal as the reference;
  * S and one camera of the cone about the written normal that S lacks,
    with the best of that set under the written normal (a camera dropped
    in the last round);

each at the reference's level for its camera and the two neighbouring
levels, as in ``check.states``. A patch so has a few hundred states at
most, and no state of another patch's own: the parent test is geometry
alone, and a patch that passes it by chance adds one state.

The states are scored by ``scores``: RefScene's fitness and correlation,
computed once per (patch, reference camera, level) for every camera the
block's sets hold, with RefScene's own ``windows``, ``warp``, ``sample``
and ``nearest``. Each state then takes RefScene's sums over its own set in
camera order (a camera outside a row's set adds exact zeros there), so its
fitness has the bits of ``RefScene.fitness``; the correlation's table is a
matrix product, which ``RefScene.correlation`` broadcasts over the window
instead ([rows, C, C, W2], hundreds of GB here), so it agrees to 1e-15 in
float64 (its bfloat16 control sums in the matrix product's order). The
reading ``cam_prunable_share`` of ``check.readings``
(Patch::removeInvisibleCamera run on every sampled patch) is left out:
its table is what does not fit. The control's depth sweep runs on the
reference restricted to the cameras its rows see.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from benchmark.reference.check import (SWEEP, STAT, best_per_patch, judge,
                                       normals, quantiles, sensitivity)
from benchmark.reference.photo import BIG, F64, RefScene

TOP_REFS = 3
NEIGHBOURS = 64
# how far, in pixels, the parent test lets the plane's point lie from a
# cell's centre: the program's centres and rays are float32, some 1e-3 px
# at the temple's scale (1e-5 px read on the tiny CPU cell); a chance point
# lands this near in one view of (2 * 0.01 / cellSize)^2 of them
CELL_CENTRE_PX = 0.01


def facing(ref: RefScene, n) -> np.ndarray:
    """normal . (-optical axis) of every camera [N, C], on the host."""
    return (-(n[:, None, :] * ref.optical).sum(-1)).to(F64).cpu().numpy()


def expansion_set(face: np.ndarray, mask: np.ndarray, cone: float,
                  min_cams: int) -> np.ndarray:
    """Patch::expandVisibleCamera (patch.cpp:723-761) of patches with
    facing scores ``face`` [K, C] and cameras ``mask`` [K, C]."""
    out = face >= cone
    lacking = out.sum(1) < min_cams
    out[lacking] |= (mask & (face >= cone / 2.0))[lacking]
    return out


def project(cams, X: np.ndarray) -> np.ndarray:
    """Pixels [K, C, 2] and depths [K, C] of points X [K, 3] in every
    camera (``cams``: RefScene's R, C, f, pp on the host)."""
    R, C, f, pp = cams
    xc = np.einsum("kcj,cij->kci", X[:, None, :] - C[None], R)
    z = xc[..., 2]
    sz = np.where(z == 0, 1.0, z)
    return f[None, :, None] * xc[..., :2] / sz[..., None] + pp[None], z


def parents(cams, c: np.ndarray, ck: np.ndarray, nk: np.ndarray,
            mk: np.ndarray, rk: np.ndarray, cell: float) -> np.ndarray:
    """Which patches (centres ck [K, 3], normals nk [K, 3], cameras mk
    [K, C], the references rk [K] of their expansion sets) can have made
    the patch at c [3] (MVS::getExpansionPatchCenter, mvs.cpp:809-836,
    then one refine): the line from the reference camera through c meets
    the parent's plane at the centre of a cell next to the parent's own
    (4-neighbours) in one of its views."""
    Cr = cams[1][rk]
    ray = c[None] - Cr
    den = (nk * ray).sum(-1)
    t = (nk * (ck - Cr)).sum(-1) / np.where(den == 0, np.inf, den)
    X0 = Cr + t[:, None] * ray
    p0, z0 = project(cams, X0)
    pk, zk = project(cams, ck)
    g = p0 / cell - 0.5
    centre = np.all(np.abs(g - np.round(g)) * cell <= CELL_CENTRE_PX, -1)
    step = np.abs(np.round(g) - np.floor(pk / cell)).sum(-1) == 1
    return (mk & centre & step & (z0 > 0) & (zk > 0)).any(1)


def states(ref: RefScene, c, n, m, cloud, visible_correlation: float,
           min_cams: int, cell_size: float):
    """The admissible (patch, reference camera, cameras, level) rows of
    the sampled patches c [N, 3], n [N, 3], m [N, C], each drawn from the
    cloud ``cloud[i]`` (``mvsfile.Cloud``), grouped by patch -> (patch
    index [R], reference camera [R], cameras [R, C], level [R])."""
    mh = m.cpu().numpy()
    ch = c.to(F64).cpu().numpy()
    face = facing(ref, n)
    optical = ref.optical.to(F64).cpu().numpy()
    cams = tuple(a.to(F64).cpu().numpy() for a in (ref.Rt, ref.Ct, ref.ft,
                                                   ref.ppt))
    pi, rc, mk = [], [], []
    for i in range(len(mh)):
        seen = set()

        def add(s, r):
            key = (int(r), np.packbits(s).tobytes())
            if key not in seen:
                seen.add(key)
                pi.append(i)
                rc.append(int(r))
                mk.append(s)

        S = mh[i]
        cams_i = np.nonzero(S)[0]
        for r in cams_i[np.argsort(-face[i, cams_i], kind="stable")[
                :TOP_REFS]]:
            add(S, r)
        for e in np.nonzero((face[i] >= visible_correlation) & ~S)[0]:
            s = S.copy()
            s[e] = True
            add(s, np.argmax(np.where(s, face[i], -np.inf)))
        cl = cloud[i]
        d = np.linalg.norm(cl.centers - ch[i], axis=1)
        near = np.argsort(d, kind="stable")[:NEIGHBOURS + 1]
        nk = normals(cl.normal_sph[near])
        fn = -(nk @ optical.T)
        sets = expansion_set(fn, cl.cam_masks[near], visible_correlation,
                             min_cams)
        refs = np.argmax(np.where(sets, fn, -np.inf), 1)
        made = parents(cams, ch[i], cl.centers[near], nk,
                       cl.cam_masks[near], refs, cell_size)
        for s, r in zip(sets[made], refs[made]):
            add(s, r)
    dev = ref.dev
    pi = torch.as_tensor(pi, device=dev)
    rc = torch.as_tensor(rc, device=dev)
    mk = torch.as_tensor(np.stack(mk), device=dev)
    lod = ref.lod(c[pi], rc)
    lmax = torch.as_tensor(ref.max_lod, device=dev)[rc]
    lv = torch.stack([(lod + d).clamp(min=0).minimum(lmax)
                      for d in (-1, 0, 1)], 1).reshape(-1)
    rep = lambda x: x.repeat_interleave(3, 0)
    return rep(pi), rep(rc), rep(mk), lv


def restricted(ref: RefScene, cams: torch.Tensor) -> RefScene:
    """``ref`` seeing only cameras ``cams`` (ascending), renumbered
    0 .. len(cams) - 1 in that order."""
    sub = copy.copy(ref)
    sub.Rt, sub.Ct, sub.ft, sub.ppt, sub.optical = (
        a[cams] for a in (ref.Rt, ref.Ct, ref.ft, ref.ppt, ref.optical))
    keep = cams.tolist()
    for name in ("levels", "var", "dims", "max_lod"):
        setattr(sub, name, [getattr(ref, name)[k] for k in keep])
    sub.num_cameras = len(keep)
    return sub


def blocks(pi: torch.Tensor, block: int):
    """Slices of the states [R] (grouped by patch) that keep each patch's
    states together: up to ``block`` states each, or one patch's."""
    starts = torch.nonzero(torch.diff(pi, prepend=pi[:1] - 1)).flatten()
    starts = starts.tolist() + [len(pi)]
    s = 0
    for k in range(1, len(starts)):
        if starts[k] - s > block and starts[k - 1] > s:
            yield slice(s, starts[k - 1])
            s = starts[k - 1]
    if s < len(pi):
        yield slice(s, len(pi))


def scores(sc: RefScene, pi, c, n, rc, mk, lod, rows: int = 4096):
    """``sc.fitness`` of one hypothesis a row at the written centre and
    ``sc.correlation`` of the state rows (patch ``pi``, centre ``c``,
    normal ``n``, reference camera ``rc``, cameras ``mk``, level ``lod``)
    -> (fitness [R], correlation [R]) float64, BIG and 0 where rejected.

    Each (patch, reference camera, level) is warped and sampled once for
    every camera the rows' sets hold, with ``sc``'s ``windows``,
    ``warp``, ``sample`` and ``nearest``; each row then takes RefScene's
    sums over its own set, in camera order, ``rows`` rows at a time. The
    correlation's table is a matrix product."""
    cams = torch.nonzero(mk.any(0)).flatten()
    R = len(pi)
    uniq, inv = torch.unique(torch.stack([pi, rc, lod], 1), dim=0,
                             return_inverse=True)
    first = torch.full((len(uniq),), R, dtype=torch.long, device=pi.device)
    first.scatter_reduce_(0, inv, torch.arange(R, device=pi.device), "amin")
    cu, nu, ru, lu = c[first], n[first], rc[first], lod[first]
    U = len(first)
    r = int(sc.p["patchRadius"])
    win, pt, s = sc.windows(cu[:, None], ru, lu)
    W2 = win.shape[2]
    # RefScene.fitness's gates: the window inside the reference frame, the
    # normal facing it, and each window pixel's foreground
    dims = sc.tensor([sc.dims[k][l] for k, l in zip(ru.tolist(),
                                                     lu.tolist())])
    h, w = dims[:, 0], dims[:, 1]
    px, py = pt[:, 0, 0], pt[:, 0, 1]
    pvalid = ((px - r >= 2) & (px + r < w - 3) & (py - r >= 2)
              & (py + r < h - 3) & ((nu * sc.optical[ru]).sum(-1) <= 0))
    fg = sc.nearest(ru[:, None, None].expand(U, 1, W2),
                    lu[:, None, None].expand(U, 1, W2), win)[:, 0] != 0
    win = win[:, 0]
    fit_v, fit_ok, vecs, oks = [], [], [], []
    for cam in cams.tolist():
        uv, hok = sc.warp(win, cu, nu, ru, cam, s)
        v, ok = sc.sample(cam, lu, uv, 2.0, 3.0)
        fit_v.append(v)
        fit_ok.append(ok & hok)
        v, vok = sc.sample(cam, lu, uv, 0.0, 1.0)
        vok &= hok
        oks.append(vok.all(-1))
        v = torch.where(vok, v, 0.0)
        nrm = torch.sqrt((v * v).sum(-1, keepdim=True))
        vecs.append(v / torch.where(nrm > 0, nrm, 1.0))
    V = torch.stack(vecs, 1)                              # [U, Cu, W2]
    table = V @ V.transpose(1, 2)                         # [U, Cu, Cu]
    cam_ok = torch.stack(oks, 1)                          # [U, Cu]
    del V, vecs
    weights = sc.dist_weights()
    diff_w = float(sc.p["diffWeighting"])
    fit = torch.full((R,), BIG, dtype=F64, device=pi.device)
    corr = torch.zeros(R, dtype=F64, device=pi.device)
    for s0 in range(0, R, rows):
        t = inv[s0:s0 + rows]
        m = mk[s0:s0 + rows][:, cams]
        k = m.sum(-1).to(sc.dt)[:, None]
        f_fg = fg[t]
        total, killed = 0, torch.zeros(len(t), dtype=torch.bool,
                                       device=pi.device)
        for j in range(len(cams)):
            mj = m[:, j, None]
            killed |= (mj & ~fit_ok[j][t] & f_fg).any(-1)
            total = total + torch.where(mj, fit_v[j][t], 0.0)
        mean = total / k
        sad = 0
        for j in range(len(cams)):
            sad = sad + torch.where(m[:, j, None],
                                    (fit_v[j][t] - mean).abs(), 0.0)
        sad = sad / k
        wfg = weights * torch.exp(-sad * sad / diff_w) * f_fg
        sw = wfg.sum(-1)
        f = (wfg * sad).sum(-1) / torch.where(sw > 0, sw, 1.0)
        fit[s0:s0 + rows] = torch.where(pvalid[t] & ~killed & (sw > 0),
                                        f.to(F64), BIG)
        tab = table[t]
        wm = m.to(tab.dtype)
        pairs = (torch.einsum("ri,rij,rj->r", wm, tab, wm)
                 - (wm * torch.diagonal(tab, dim1=1, dim2=2)).sum(-1))
        den = (k * k - k)[:, 0]
        q = pairs / torch.where(den > 0, den, 1.0)
        ok = (cam_ok[t] | ~m).all(-1)
        corr[s0:s0 + rows] = torch.where(ok, q, 0.0).to(F64)
    return fit, corr


def readings(ref: RefScene, ctl, sample, surface, cloud,
             visible_correlation: float, min_cams: int, cell_size: float,
             block: int = 4096, sweep_block: int = 32) -> dict:
    """``check.readings`` over these states (``cloud[i]``: the cloud the
    sampled patch i was drawn from): ``program`` judges the
    written patches; with a control scene ``ctl`` (a ``RefScene``, or
    None) ``control`` judges the control's answers in the program's place
    by the same numbers, and ``reference`` holds the reference's own depth
    sweep. Readings kept beside them are at the top level."""
    N = len(sample)
    if N == 0:      # an empty cloud: nothing agrees with the reference
        nan = {"fit_gap": float("nan"), "fit_gap_max": float("nan"),
               "corr_gap": float("nan"), "depth_px": float("nan")}
        return {"patches": 0, "program": nan,
                **({"control": nan} if ctl is not None else {})}
    t = lambda a, sc: torch.as_tensor(a, dtype=F64, device=ref.dev).to(sc.dt)
    c, n = t(sample.centers, ref), t(sample.normals, ref)
    m = torch.as_tensor(sample.masks, device=ref.dev)
    pi, rc, mk, lod = states(ref, c, n, m, cloud, visible_correlation,
                             min_cams, cell_size)
    R = len(pi)
    f_ref, f_ctl = np.empty(R), np.full(R, np.nan)
    q_ref, q_ctl = np.empty(R), np.full(R, np.nan)
    for sl in blocks(pi, block):
        idx = pi[sl]
        args = (rc[sl], mk[sl], lod[sl])
        f, q = scores(ref, idx, c[idx], n[idx], *args)
        f_ref[sl], q_ref[sl] = f.cpu().numpy(), q.cpu().numpy()
        if ctl is not None:
            f, q = scores(ctl, idx, c[idx].to(ctl.dt), n[idx].to(ctl.dt),
                          *args)
            f_ctl[sl], q_ctl[sl] = f.cpu().numpy(), q.cpu().numpy()
    pin = pi.cpu().numpy()
    ok = f_ref < BIG / 2
    fit = lambda a: best_per_patch(np.where(
        ok, np.abs(a - f_ref) / np.maximum(f_ref, 1e-12), np.inf), pin, N)
    corr = lambda a: best_per_patch(np.abs(a - q_ref), pin, N)

    # the depth along the written reference ray, against the surface
    rc0 = ref.ref_camera(n, m)
    lod0 = ref.lod(c, rc0)
    ray, d_prog, ppd = sensitivity(ref, c, rc0, m)
    C_ref = ref.Ct[rc0]
    t_true, _ = surface.cast(C_ref.cpu().numpy(), ray.cpu().numpy())
    d_true = torch.as_tensor(t_true, dtype=F64, device=ref.dev)
    steps = torch.as_tensor(SWEEP, dtype=F64, device=ref.dev)
    dep = {"reference": torch.zeros(N, dtype=F64, device=ref.dev)}
    dep["control"] = dep["reference"].clone()
    sweeps = (("reference", ref), ("control", ctl)) if ctl is not None \
        else ()
    for s in range(0, N, sweep_block):
        sl = slice(s, s + sweep_block)
        cams = torch.nonzero(m[sl].any(0)).flatten()
        pos = torch.searchsorted(cams, rc0[sl])
        args = (pos, m[sl][:, cams], lod0[sl])
        depths = d_true[sl, None] + steps / ppd[sl, None]        # [b, K]
        for name, sc in sweeps:
            hyp = (sc.Ct[rc0[sl]][:, None, :]
                   + depths[..., None].to(sc.dt) * ray[sl, None, :].to(sc.dt))
            f = restricted(sc, cams).fitness(hyp, n[sl].to(sc.dt), *args)
            k = torch.argmin(f, -1)
            dep[name][sl] = depths[torch.arange(len(k), device=ref.dev), k]
    px = lambda dd: (torch.abs(dd - d_true) * ppd).cpu().numpy()
    out = {"patches": N, "states": R,
           "program": judge(fit(sample.fitness[pin]),
                            corr(sample.correlation[pin]), px(d_prog))}
    if ctl is not None:
        out["control"] = judge(fit(f_ctl), corr(q_ctl), px(dep["control"]))
        out["reference"] = {"depth_px": quantiles(px(dep["reference"]))[
            STAT["depth_px"]]}
    out["sample_surface_dist_median"] = float(np.median(
        surface.distance(sample.centers)))
    return out
