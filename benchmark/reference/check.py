"""The comparison that decides ``correct``: the clouds that the timed jobs
wrote, judged by the plain reference (``photo.py``) and the analytic
surface the benchmark rendered.

A written patch carries its centre, normal, cameras, fitness and
correlation. The program scored the fitness and the correlation in the
last refine round with the reference camera, camera set and level of
detail that the patch had before that round's PSO; the file keeps the
state after it. So the reference scores each sampled patch at its written
centre and normal under every admissible state (a reference camera of
the set; the written cameras, or those and one more; the reference's
level for that camera and its two neighbours) and keeps the state that
agrees best. Numbers, over the sampled patches:

  fit_gap     the 90th percentile of |program fitness - reference
              fitness| / reference fitness (the scene build's atlases,
              K1, the engine, the writers);
  fit_gap_max the widest of those gaps: no judged patch may be wrong by
              more than its limit;
  corr_gap    the 90th percentile of |program correlation - reference
              correlation| (K2's windows, the NCC table);
  depth_px    the median depth error along each patch's reference ray,
              in pixels of disparity in its most sensitive other camera,
              against the analytic surface (the PSO's search, the
              insertion).

Up to a tenth of the pawn rig's patches (a few in a thousand of the
facade's) had their state of the last round changed by more than the
admissible states cover (two cameras dropped, the level
moved by two), so the widest gap swings from run to run; the 90th
percentile does not, and the widest gap is held to a limit of its own
above those swings.

With a control scene the control stands in the program's place: the
reference one step below each precision the configuration states
(bfloat16 arithmetic, float8 atlases) gives the fitness and correlation
under the same states and the depth it puts first on a sweep along the
same rays, and those answers are judged by the same numbers in place of
the program's (``readings(...)["control"]``). Readings kept beside
them, not compared: the reference's own sweep, the share of patches
whose written cameras the visible-camera rule would prune, the median
surface distance.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.photo import BIG, F64, RefScene

SWEEP = np.arange(-30, 31) / 10.0    # disparity pixels around the truth


def normals(sph: np.ndarray) -> np.ndarray:
    st = np.sin(sph[:, 0])
    return np.stack([st * np.cos(sph[:, 1]), st * np.sin(sph[:, 1]),
                     np.cos(sph[:, 0])], -1)


class Sample:
    """Patches drawn from the jobs' clouds: centre, normal, cameras and
    the program's fitness and correlation."""

    def __init__(self, centers, sph, masks, fitness, correlation):
        self.centers = np.asarray(centers, float)
        self.normals = normals(np.asarray(sph, float))
        self.masks = np.asarray(masks, bool)
        self.fitness = np.asarray(fitness, float)
        self.correlation = np.asarray(correlation, float)

    def __len__(self):
        return len(self.centers)


def states(ref: RefScene, c, n, m):
    """The admissible (patch, reference camera, cameras, level) rows of
    the sampled patches c [N, 3], n [N, 3], m [N, C] -> (patch index [R],
    reference camera [R], cameras [R, C], level [R])."""
    N, C = m.shape
    pi, rc, mk = [], [], []
    mh = m.cpu().numpy()
    for i in range(N):
        sets = [mh[i]] + [mh[i] | (np.arange(C) == e)
                          for e in range(C) if not mh[i, e]]
        for s in sets:
            for r in np.nonzero(s)[0]:
                pi.append(i)
                rc.append(r)
                mk.append(s)
    pi = torch.as_tensor(pi, device=ref.dev)
    rc = torch.as_tensor(rc, device=ref.dev)
    mk = torch.as_tensor(np.stack(mk), device=ref.dev)
    lod = ref.lod(c[pi], rc)
    lmax = torch.as_tensor(ref.max_lod, device=ref.dev)[rc]
    rows = [(pi, rc, mk, (lod + d).clamp(min=0).minimum(lmax))
            for d in (-1, 0, 1)]
    return [torch.cat(x) for x in zip(*rows)]


def best_per_patch(gap: np.ndarray, patch: np.ndarray, N: int):
    out = np.full(N, np.inf)
    np.minimum.at(out, patch, gap)
    return out


def sensitivity(ref: RefScene, c, rc, m):
    """(unit rays from the reference cameras through the centres [N, 3],
    depths [N], pixels moved per unit of depth in the most sensitive other
    visible camera [N])."""
    ray = c - ref.Ct[rc]
    d = torch.linalg.norm(ray, dim=-1)
    ray = ray / d[:, None]
    eps = 1e-6 * d
    cams = torch.arange(ref.num_cameras, device=ref.dev)
    p0, _ = ref.project(c[:, None, :], cams)
    p1, _ = ref.project((c + eps[:, None] * ray)[:, None, :], cams)
    px = torch.linalg.norm(p1 - p0, dim=-1) / eps[:, None]      # [N, C]
    other = m & (cams != rc[:, None])
    return ray, d, torch.where(other, px, 0.0).max(-1).values


QUANTILES = {"median": 0.5, "p90": 0.9, "p95": 0.95, "p98": 0.98}
# the statistic of each compared number over the sampled patches
STAT = {"fit_gap": "p90", "corr_gap": "p90", "depth_px": "median"}


def quantiles(x) -> dict:
    x = np.asarray(x, float)
    x = x[np.isfinite(x)]
    out = {k: (float(np.quantile(x, q)) if len(x) else float("nan"))
           for k, q in QUANTILES.items()}
    out["max"] = float(x.max()) if len(x) else float("nan")
    return out


def judge(fit_gap, corr_gap, depth_px) -> dict:
    """The compared numbers from per-patch gaps [N] (inf where no
    admissible state scored), with their other quantiles and the count of
    unmatched patches beside them."""
    out = {}
    for name, gaps in (("fit_gap", fit_gap), ("corr_gap", corr_gap),
                       ("depth_px", depth_px)):
        q = quantiles(gaps)
        out[name] = q.pop(STAT[name])
        out.update({f"{name}_{k}": v for k, v in q.items()})
        out[name + "_unmatched"] = int((~np.isfinite(gaps)).sum())
    return out


def readings(ref: RefScene, ctl, sample: Sample, surface,
             block: int = 256, sweep_block: int = 32) -> dict:
    """The numbers of the comparison: ``program`` judges the written
    patches; with a control scene ``ctl`` (a ``RefScene``, or None)
    ``control`` judges the control's answers in the program's place by the
    same numbers, and ``reference`` holds the reference's own depth
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
    pi, rc, mk, lod = states(ref, c, n, m)
    R = len(pi)
    f_ref, f_ctl = np.empty(R), np.full(R, np.nan)
    q_ref, q_ctl = np.empty(R), np.full(R, np.nan)
    for s in range(0, R, block):
        sl = slice(s, s + block)
        idx = pi[sl]
        args = (rc[sl], mk[sl], lod[sl])
        f_ref[sl] = ref.fitness(c[idx, None], n[idx], *args)[:, 0].cpu(
        ).numpy()
        q_ref[sl] = ref.correlation(c[idx], n[idx], *args)[0].cpu().numpy()
        if ctl is not None:
            cq, nq = c[idx].to(ctl.dt), n[idx].to(ctl.dt)
            f_ctl[sl] = ctl.fitness(cq[:, None], nq, *args)[:, 0].cpu(
            ).numpy()
            q_ctl[sl] = ctl.correlation(cq, nq, *args)[0].cpu().numpy()
    pin = pi.cpu().numpy()
    ok = f_ref < BIG / 2
    # each answer [R] (one per admissible state) against the reference's
    # under the same state, the best state kept per patch
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
    drop = torch.zeros(N, dtype=torch.bool, device=ref.dev)
    sweeps = (("reference", ref), ("control", ctl)) if ctl is not None \
        else ()
    for s in range(0, N, sweep_block):
        sl = slice(s, s + sweep_block)
        args = (rc0[sl], m[sl], lod0[sl])
        depths = d_true[sl, None] + steps / ppd[sl, None]        # [b, K]
        for name, sc in sweeps:
            hyp = (sc.Ct[rc0[sl]][:, None, :]
                   + depths[..., None].to(sc.dt) * ray[sl, None, :].to(sc.dt))
            f = sc.fitness(hyp, n[sl].to(sc.dt), *args)
            k = torch.argmin(f, -1)
            dep[name][sl] = depths[torch.arange(len(k), device=ref.dev), k]
        drop[sl] = ref.removed_cameras(c[sl], n[sl], *args).any(-1)
    px = lambda dd: (torch.abs(dd - d_true) * ppd).cpu().numpy()
    out = {"patches": N, "states": R,
           "program": judge(fit(sample.fitness[pin]),
                            corr(sample.correlation[pin]), px(d_prog))}
    if ctl is not None:
        out["control"] = judge(fit(f_ctl), corr(q_ctl), px(dep["control"]))
        out["reference"] = {"depth_px": quantiles(px(dep["reference"]))[
            STAT["depth_px"]]}
    out["cam_prunable_share"] = float(drop.double().mean())
    out["sample_surface_dist_median"] = float(np.median(
        surface.distance(sample.centers)))
    return out
