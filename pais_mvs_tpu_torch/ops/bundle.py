"""Pose-refinement bundle adjustment with a distributed Schur complement.

The PyTorch counterpart of ``pais_mvs_tpu/ops/bundle.py``. NEW SCOPE vs the
reference: TMVS takes VisualSFM poses as fixed ground truth
(TMVS/io/fileloader.cpp:251-325 just parses them). This module:

* residuals r_{m,c} = project(R_c (X_m - C_c)) - obs_{m,c} over n-view
  tracks (the same tracks the seeder produces);
* Levenberg-Marquardt normal equations with the POINT blocks eliminated by
  a Schur complement: S = U - W H_pp^-1 W^T over cameras, then
  back-substitution for the points;
* every per-track quantity (H_pp, W, b) is an independent reduction over
  tracks, so the track axis shards over ranks and the reduced [6C, 6C]
  camera system assembles with one psum; the small dense solve is
  replicated.

Camera deltas are (axis-angle w, center delta dc): R <- exp([w]x) R,
C <- C + dc. f32 throughout, as the jitted JAX function runs; the JAX
``vmap``s over (track, camera) are closed-form tensors over [M, C], its
``lax.scan`` over track chunks a Python loop. The LM loop is a fixed
iteration count with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BaProblem(NamedTuple):
    """Inputs: C cameras, M tracks (fixed shapes, masked)."""
    R: torch.Tensor           # [C, 3, 3]
    center: torch.Tensor      # [C, 3]
    focal: torch.Tensor       # [C, 2]
    principal: torch.Tensor   # [C, 2]
    points: torch.Tensor      # [M, 3]
    obs: torch.Tensor         # [M, C, 2] observed pixels
    mask: torch.Tensor        # [M, C] bool


class BaResult(NamedTuple):
    R: torch.Tensor
    center: torch.Tensor
    points: torch.Tensor
    rms_history: torch.Tensor  # [iters + 1] masked reprojection RMS (px)


def _skew(v):
    """[..., 3] -> [..., 3, 3] cross-product matrices [v]x."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        torch.stack([z, -w, y], -1),
        torch.stack([w, z, -x], -1),
        torch.stack([-y, x, z], -1)], -2)


def _exp_so3(w):
    """Rodrigues: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    big = theta > 1e-12
    K = _skew(w / torch.where(big, theta, torch.ones_like(theta)))
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    Rr = eye + s * K + (1 - c) * (K @ K)
    return torch.where(big[..., None], Rr, eye + K)


def _residual_and_jac(R, C0, f, pp, X, obs):
    """Residuals [M, C, 2] + Jacobians wrt (w[3], dc[3]) [M, C, 2, 6] and
    X [M, C, 2, 3], and the camera-frame depth [M, C].

    Closed form around delta=0: x = R(X - C), u = f x/z + pp;
    d x / d w = -[x]x (left-multiplied exp), d x / d dc = -R, d x / dX = R.
    """
    d = X[:, None, :] - C0[None]                              # [M, C, 3]
    x = (R[None] * d[:, :, None, :]).sum(-1)                  # R @ d
    z = torch.where(x[..., 2] == 0, torch.ones_like(x[..., 2]), x[..., 2])
    u = f * x[..., :2] / z[..., None] + pp
    r = u - obs
    # d u / d x : [M, C, 2, 3]
    zero = torch.zeros_like(z)
    f0, f1 = f[..., 0], f[..., 1]
    du = torch.stack([
        torch.stack([f0 / z, zero, -(f0 * x[..., 0] / (z * z))], -1),
        torch.stack([zero, f1 / z, -(f1 * x[..., 1] / (z * z))], -1)], -2)
    Jw = du @ (-_skew(x))
    Jc = du @ (-R)
    Jp = du @ R
    return r, torch.cat([Jw, Jc], -1), Jp, x[..., 2]


def _assemble(R, center, focal, principal, points, obs, mask, damping):
    """Per-shard: masked LM normal-equation pieces, reduced over tracks.

    Returns (S [C6, C6], rhs [C6], Hpp_inv [M,3,3], bp [M,3], W [M,C,6,3],
    sse, n_obs) where C6 = 6C. Everything except the M-indexed outputs is a
    plain sum over the local tracks — psum-able.
    """
    M, C = mask.shape
    r, Jcam, Jp, z = _residual_and_jac(R, center, focal, principal, points,
                                       obs)
    w = (mask & (z > 0)).to(points.dtype)
    r = r * w[..., None]
    Jcam = Jcam * w[..., None, None]
    Jp = Jp * w[..., None, None]

    eye3 = torch.eye(3, dtype=points.dtype, device=points.device)
    Hpp = torch.einsum("mcki,mckj->mij", Jp, Jp) + damping * eye3[None]
    bp = -torch.einsum("mcki,mck->mi", Jp, r)                # [M, 3]
    W = torch.einsum("mcki,mckj->mcij", Jcam, Jp)            # [M, C, 6, 3]
    U = torch.einsum("mcki,mckj->cij", Jcam, Jcam)           # [C, 6, 6]
    bc = -torch.einsum("mcki,mck->ci", Jcam, r)              # [C, 6]

    Hpp_inv = torch.linalg.inv(Hpp)
    WHi = torch.einsum("mcij,mjk->mcik", W, Hpp_inv)         # [M, C, 6, 3]
    S_red = torch.einsum("mcik,mdjk->cidj", WHi, W)          # [C,6,C,6]
    rhs_red = torch.einsum("mcik,mk->ci", WHi, bp)

    C6 = 6 * C
    # the block-diagonal U; the caller adds the LM damping AFTER any
    # cross-rank psum so it isn't multiplied by the rank count
    S = -S_red.reshape(C6, C6) + torch.block_diag(*U.unbind(0))
    rhs = bc.reshape(C6) - rhs_red.reshape(C6)

    sse = torch.sum(r * r)
    n_obs = torch.sum(mask)
    return S, rhs, Hpp_inv, bp, W, sse, n_obs


def _pad_tracks(points, obs, mask, chunk):
    M = points.shape[0]
    pad = (-M) % chunk
    if pad:
        points = torch.cat([points, points.new_zeros((pad, 3))])
        obs = torch.cat([obs, obs.new_zeros((pad,) + obs.shape[1:])])
        mask = torch.cat([mask, mask.new_zeros((pad,) + mask.shape[1:])])
    return points, obs, mask, M


def _chunks(points, obs, mask, chunk):
    pts, ob, mk, _ = _pad_tracks(points, obs, mask, chunk)
    for s in range(0, pts.shape[0], chunk):
        yield pts[s:s + chunk], ob[s:s + chunk], mk[s:s + chunk]


def _reduced_system(R, center, focal, principal, points, obs, mask,
                    damping, chunk: int):
    """Schur-reduced camera system accumulated over track CHUNKS: the
    per-track Jacobian blocks ([chunk, C, ...]) never materialize for the
    whole track set, so memory is O(chunk x C) instead of O(M x C)."""
    C6 = 6 * R.shape[0]
    dev, dt = points.device, points.dtype
    S = torch.zeros((C6, C6), dtype=dt, device=dev)
    rhs = torch.zeros(C6, dtype=dt, device=dev)
    sse = torch.zeros((), dtype=dt, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    for p, o, m in _chunks(points, obs, mask, chunk):
        cS, crhs, _, _, _, csse, cn = _assemble(R, center, focal, principal,
                                                p, o, m, damping)
        S, rhs, sse, n = S + cS, rhs + crhs, sse + csse, n + cn
    return S, rhs, sse, n


def _point_updates(R, center, focal, principal, points, obs, mask,
                   damping, dc, chunk: int):
    """Back-substitution dp per track, chunked like _reduced_system."""
    dps = []
    for p, o, m in _chunks(points, obs, mask, chunk):
        _, _, Hpp_inv, bp, W, _, _ = _assemble(R, center, focal, principal,
                                               p, o, m, damping)
        rhs = bp - torch.einsum("mcij,ci->mj", W, dc)
        dps.append(torch.einsum("mij,mj->mi", Hpp_inv, rhs))
    return torch.cat(dps)[:points.shape[0]]


def _solve_preconditioned(S, rhs):
    """Jacobi-preconditioned dense solve: the Schur system mixes rotation
    and translation units, so D^-1/2 S D^-1/2 drops the condition number
    enough for a stable f32 solve."""
    d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    Sp = S / (d[:, None] * d[None, :])
    y = torch.linalg.solve(Sp, rhs / d)
    return y / d


def _apply_updates(R, center, points, dc, dp):
    Rn = _exp_so3(dc[:, :3]) @ R
    return Rn, center + dc[:, 3:], points + dp


def _sse(R, center, focal, principal, points, obs, mask):
    """Residual-only pass: (masked sum of squared residuals, obs count)."""
    r, _, _, z = _residual_and_jac(R, center, focal, principal, points, obs)
    ok = (mask & (z > 0)).to(points.dtype)
    return torch.sum((r * r).sum(-1) * ok), torch.sum(mask)


def _gauge(C: int, fix_first_camera: bool, like: torch.Tensor):
    gauge = torch.ones(6 * C, dtype=like.dtype, device=like.device)
    if fix_first_camera:
        gauge[:6] = 0.0
    return gauge


def _lm_step(S, rhs, gauge, damping, C):
    """Damp, pin the gauge rows/cols and solve the reduced system."""
    C6 = 6 * C
    eye = torch.eye(C6, dtype=S.dtype, device=S.device)
    S = S + damping * eye
    S = S * gauge[:, None] * gauge[None, :] + torch.diag(1.0 - gauge)
    return _solve_preconditioned(S, rhs * gauge).reshape(C, 6)


def bundle_adjust(problem: BaProblem, num_iters: int = 10,
                  damping: float = 1e-3,
                  fix_first_camera: bool = True,
                  chunk: int = 2048) -> BaResult:
    """Single-device LM bundle adjustment (fixed iteration count), on the
    problem's device.

    ``fix_first_camera`` gauges the solution by pinning camera 0 (removes
    the 6-dof global gauge freedom; scale gauge is left to the damping).
    ``chunk`` bounds the per-step Jacobian memory to O(chunk x cameras).
    """
    R, center, points = problem.R, problem.center, problem.points
    f, pp, obs, mask = (problem.focal, problem.principal, problem.obs,
                        problem.mask)
    C = R.shape[0]
    chunk = max(1, min(chunk, points.shape[0]))

    def rms(R, center, points):
        sse, n = _sse(R, center, f, pp, points, obs, mask)
        return torch.sqrt(sse / (2.0 * torch.clamp(n, min=1)))

    history = [rms(R, center, points)]
    gauge = _gauge(C, fix_first_camera, points)
    for _ in range(num_iters):
        S, rhs, _, _ = _reduced_system(R, center, f, pp, points, obs, mask,
                                       damping, chunk)
        dc = _lm_step(S, rhs, gauge, damping, C)
        dp = _point_updates(R, center, f, pp, points, obs, mask, damping,
                            dc, chunk)
        R, center, points = _apply_updates(R, center, points, dc, dp)
        history.append(rms(R, center, points))
    return BaResult(R, center, points, torch.stack(history))


def bundle_adjust_sharded(problem: BaProblem, collective,
                          num_iters: int = 10,
                          damping: float = 1e-3,
                          fix_first_camera: bool = True,
                          chunk: int = 2048) -> BaResult:
    """Track-sharded LM bundle adjustment over the ranks of
    ``collective`` (a ``parallel.mesh.Collective``, the port's stand-in for
    JAX's ``(mesh, axis)``).

    Every rank passes the whole problem. The tracks are padded (with
    unobserved rows) to a multiple of the rank count; each rank assembles
    the Schur pieces of its own slice and one psum produces the replicated
    reduced camera system (the distributed Schur-complement reduction of
    BASELINE.json config 5). Point back-substitution stays local; the
    updated points come back whole on every rank.
    """
    R, center = problem.R, problem.center
    f, pp = problem.focal, problem.principal
    C = R.shape[0]
    M = problem.points.shape[0]
    n_ranks, me = collective.size, collective.index
    points, obs, mask, _ = _pad_tracks(problem.points, problem.obs,
                                       problem.mask, n_ranks)
    m_local = points.shape[0] // n_ranks
    sl = slice(me * m_local, (me + 1) * m_local)
    points, obs, mask = points[sl], obs[sl], mask[sl]
    ck = max(1, min(chunk, m_local))
    psum = collective.psum

    def rms(R, center, points):
        sse, n = _sse(R, center, f, pp, points, obs, mask)
        return torch.sqrt(psum(sse) / (2.0 * torch.clamp(psum(n), min=1)))

    hist = [rms(R, center, points)]
    gauge = _gauge(C, fix_first_camera, points)
    for _ in range(num_iters):
        S, rhs, _, _ = _reduced_system(R, center, f, pp, points, obs, mask,
                                       damping, ck)
        dc = _lm_step(psum(S), psum(rhs), gauge, damping, C)
        dp = _point_updates(R, center, f, pp, points, obs, mask, damping,
                            dc, ck)
        R, center, points = _apply_updates(R, center, points, dc, dp)
        hist.append(rms(R, center, points))
    points = collective.all_gather(points, 0)[:M]
    return BaResult(R, center, points, torch.stack(hist))
