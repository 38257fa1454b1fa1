"""Batched GLN-PSO: B independent swarms advancing in lockstep.

The PyTorch counterpart of ``pais_mvs_tpu/ops/pso.py``. The reference
optimizer (TMVS/pso/psosolver.cpp) runs ONE swarm at a time and
parallelizes over its ~10-30 particles with OpenMP; here the batch axis is
the *patch* axis: state is ``[B, P, D]`` and a whole batch of swarms takes
each step together.

Semantics matched to the reference:
  * velocity update v <- iw*v + pw*r*(pBest-x) + gw*r*(gBest-x)
    [+ lw*r*(lBest-x) + nw*r*(nBest-x) in GLN mode], one random scalar per
    particle per term (psosolver.cpp:230-254), position clamped to bounds;
  * lBest = best pBest among the localK nearest pBests (Euclidean,
    psosolver.cpp:151-191); nBest = per-dimension fitness-distance-ratio
    argmax (psosolver.cpp:193-218);
  * early stop per swarm when both the dispersion index (mean |pos-gBest|)
    and velocity index (mean |vel|) drop below the threshold
    (psosolver.cpp:70-92, 295) — converged swarms freeze;
  * inertia decays linearly by 1/maxIteration to 0.4 (psosolver.cpp:304);
  * particle 0 can be seeded with the incumbent solution (setParticle).

Randomness: every uniform the optimizer consumes is drawn up front into a
``PsoDraws`` (from a ``torch.Generator``), or injected by the caller. The
JAX package draws from ``jax.random``, which torch cannot reproduce, so the
parity tests inject the JAX draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pais_mvs_tpu_torch import resolve_device


class PsoResult(NamedTuple):
    gbest: torch.Tensor        # [B, D]
    gbest_fit: torch.Tensor    # [B]
    iterations: torch.Tensor   # [B] int32 iterations actually run


class PsoDraws(NamedTuple):
    """Every uniform in [0, 1) one ``gln_pso`` run consumes."""

    pos: torch.Tensor    # [B, P, D] initial positions
    vel: torch.Tensor    # [B, P, D] initial velocities
    steps: torch.Tensor  # [max_iteration, 4 (GLN) or 2, B, P] per step


def draw_uniforms(B: int, P: int, D: int, max_iteration: int,
                  enable_gln: bool = True,
                  generator: torch.Generator | None = None,
                  device="cuda") -> PsoDraws:
    """Draw a run's uniforms from ``generator`` (on ``device``)."""
    device = resolve_device(device)
    u = lambda *s: torch.rand(s, generator=generator, device=device)
    return PsoDraws(u(B, P, D), u(B, P, D),
                    u(max_iteration, 4 if enable_gln else 2, B, P))


def _gather_rows(x, idx):
    """x [B, P, ...] at idx [B, Q] along axis 1 -> [B, Q, ...]."""
    idx = idx.long()
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _local_best(pbest, pbest_fit, local_k: int):
    """lBest per particle: among the local_k nearest pBests (excluding
    self), the one with minimum pBest fitness. pbest: [B, P, D].

    K iterative argmin extractions (ties broken by the lowest index, as in
    the JAX package). The Gram-matrix form of the squared distance mirrors
    the JAX package's, so the same rounding decides the same neighbours."""
    n2 = (pbest * pbest).sum(-1)                              # [B, P]
    gram = (pbest[:, :, None, :] * pbest[:, None, :, :]).sum(-1)
    dist2 = n2[:, :, None] + n2[:, None, :] - 2.0 * gram      # [B, P, P]
    P = pbest.shape[1]
    eye = torch.eye(P, dtype=torch.bool, device=pbest.device)
    dist2 = torch.where(eye, torch.inf, dist2)
    iota = torch.arange(P, device=pbest.device)
    best_fit = torch.full_like(pbest_fit, torch.inf)
    best_idx = torch.zeros(pbest_fit.shape, dtype=torch.long,
                           device=pbest.device)
    for _ in range(local_k):
        j = torch.argmin(dist2, dim=-1)                       # [B, P]
        fitj = torch.gather(pbest_fit, 1, j)
        upd = fitj < best_fit
        best_fit = torch.where(upd, fitj, best_fit)
        best_idx = torch.where(upd, j, best_idx)
        dist2 = torch.where(iota == j[:, :, None], torch.inf, dist2)
    return _gather_rows(pbest, best_idx)


def _fdr_best(pos, fit, pbest, pbest_fit):
    """nBest per particle per dimension: argmax_j (fit_i - pbestFit_j) /
    |pos_i[d] - pbest_j[d]| over j != i (psosolver.cpp:193-218)."""
    B, P, D = pos.shape
    num = fit[:, :, None] - pbest_fit[:, None, :]             # [B, P, P]
    eye = torch.eye(P, dtype=torch.bool, device=pos.device)
    cols = []
    for d in range(D):
        den = torch.abs(pos[:, :, None, d] - pbest[:, None, :, d])
        fdr = num / den                                       # inf/-inf ok
        fdr = torch.where(torch.isnan(fdr) | eye, -torch.inf, fdr)
        jbest = torch.argmax(fdr, dim=2)                      # [B, P]
        cols.append(torch.gather(pbest[..., d], 1, jbest))
    return torch.stack(cols, dim=-1)


def gln_pso(fit_fn: Callable, range_l, range_u, init,
            particle_num: int, max_iteration: int,
            draws: PsoDraws | None = None,
            generator: torch.Generator | None = None,
            enable_gln: bool = True,
            convergence_threshold: float = 0.01,
            iw: float = 0.8, pw: float = 1.2, gw: float = 1.5,
            lw: float = 1.0, nw: float = 1.0, local_k: int = 5,
            min_iw: float = 0.4, active0=None,
            exit_chunk: int = 0) -> PsoResult:
    """Run B swarms of ``particle_num`` particles for <= max_iteration steps.

    Args:
      fit_fn: (pos [B, P, D], active [B] bool) -> fitness [B, P] (lower is
        better). ``active`` marks swarms whose result will be used this
        iteration — a kernel may return BIG rows for the others.
      range_l / range_u: [B, D] per-swarm bounds.
      init: [B, D] incumbent seeded into particle 0 (pos and pBest), or None.
      draws: the run's uniforms (``PsoDraws``); drawn from ``generator``
        when None.
      active0: [B] bool or None — swarms to optimize at all.
      exit_chunk: > 0 checks every ``exit_chunk`` iterations whether EVERY
        swarm has frozen and stops the loop if so (the batch analog of the
        reference's per-swarm early stop, psosolver.cpp:286-306). Bit-
        identical to the fixed loop: frozen swarms never change state, and
        ``iterations`` counts only the steps a swarm took. Each check reads
        one flag back from the device, so under a CUDA-graph capture the
        fixed loop runs instead. 0 = fixed loop.

    Returns: PsoResult.
    """
    B, D = range_l.shape
    P = particle_num
    dev = range_l.device
    # lBest draws from the localK nearest OTHER particles (psosolver.cpp:
    # 151-191); with small swarms K must stay below P
    K = min(local_k, max(P - 1, 1))
    inter = range_u - range_l
    if active0 is None:
        active0 = torch.ones(B, dtype=torch.bool, device=dev)
    if draws is None:
        draws = draw_uniforms(B, P, D, max_iteration, enable_gln,
                              generator, dev)

    pos = range_l[:, None] + inter[:, None] * draws.pos
    vel = inter[:, None] * (2.0 * draws.vel - 1.0)
    if init is not None:
        pos = pos.clone()
        pos[:, 0, :] = init

    fit = fit_fn(pos, active0)
    fit = torch.where(active0[:, None], fit, torch.inf)
    pbest = pos
    pbest_fit = fit
    gi = torch.argmin(pbest_fit, dim=-1)
    gbest = _gather_rows(pbest, gi[:, None])[:, 0]
    gbest_fit = torch.gather(pbest_fit, 1, gi[:, None])[:, 0]
    iwv = torch.full((B,), iw, dtype=pos.dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        exit_chunk = 0

    for it in range(max_iteration):
        if (exit_chunk > 0 and it > 0 and it % exit_chunk == 0
                and not bool(torch.any(~done & active0))):
            break
        r4 = draws.steps[it]
        # convergence indices (psosolver.cpp:70-92)
        disp = torch.abs(pos - gbest[:, None, :]).mean((1, 2))
        velix = torch.abs(vel).mean((1, 2))
        done = done | ((disp < convergence_threshold) &
                       (velix < convergence_threshold))
        active = ~done & active0

        rp = pw * r4[0][..., None]
        rg = gw * r4[1][..., None]
        dv = rp * (pbest - pos) + rg * (gbest[:, None, :] - pos)
        if enable_gln:
            rl = lw * r4[2][..., None]
            rn = nw * r4[3][..., None]
            lbest = _local_best(pbest, pbest_fit, K)
            # FDR uses the particle's CURRENT fitness (psosolver.cpp:195)
            nbest = _fdr_best(pos, fit, pbest, pbest_fit)
            dv = dv + rl * (lbest - pos) + rn * (nbest - pos)

        vel_new = iwv[:, None, None] * vel + dv
        pos_new = torch.clamp(pos + vel_new, range_l[:, None],
                              range_u[:, None])

        a3 = active[:, None, None]
        pos = torch.where(a3, pos_new, pos)
        vel = torch.where(a3, vel_new, vel)

        f = fit_fn(pos, active)
        better = (f < pbest_fit) & active[:, None]
        pbest = torch.where(better[..., None], pos, pbest)
        pbest_fit = torch.where(better, f, pbest_fit)

        gi = torch.argmin(pbest_fit, dim=-1)
        gbest_fit = torch.gather(pbest_fit, 1, gi[:, None])[:, 0]
        gbest = _gather_rows(pbest, gi[:, None])[:, 0]

        iw2 = torch.clamp(iwv - 1.0 / max_iteration, min=min_iw)
        iwv = torch.where(active, iw2, iwv)
        fit = torch.where(active[:, None], f, fit)
        iters = iters + active.to(torch.int32)
    return PsoResult(gbest, gbest_fit, iters)
