"""Patch refinement over the (patch, view) layout: patch-sharded swarms x
view-sharded atlases.

The counterpart of ``pais_mvs_tpu/parallel/sharded.py`` (one
``shard_map``) and of the view-sharded ``refine_batch`` the JAX package
runs inside one. Each rank holds a slice of the patch batch (its patch
index) and one camera block of the atlases (its view index,
``Scene.view_block``). Cross-view photoconsistency terms compose with
sums over the view group (``ops/view_fitness.py``); the results are
all-gathered over the patch group, so every rank returns the whole batch.

PSO draws come from ``(seed, patch index)`` and never from the view index:
the view ranks of one patch slice must run identical swarms, or every
psum they share mixes different particles without a sign
(pais_mvs_tpu/parallel/sharded.py:77).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.models.patch import PatchBatch, _map
from pais_mvs_tpu_torch.ops import lifecycle as lc
from pais_mvs_tpu_torch.ops import view_fitness as VF
from pais_mvs_tpu_torch.ops.pso import PsoDraws, PsoResult, gln_pso


def patch_seed(seed: int, patch_index: int) -> int:
    """The PSO seed of one patch slice (the same on all its view ranks)."""
    return seed * 1_000_003 + patch_index


def _patch_slice(B: int, patch) -> slice:
    if B % patch.size:
        raise ValueError(f"the batch of {B} patches does not split over "
                         f"the patch axis of size {patch.size}")
    n = B // patch.size
    return slice(patch.index * n, (patch.index + 1) * n)


def _slice_draws(draws: PsoDraws, sl: slice) -> PsoDraws:
    """The rows ``sl`` of a batch's PSO uniforms."""
    return PsoDraws(draws.pos[sl], draws.vel[sl], draws.steps[:, :, sl])


def _generator(seed: int, patch, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        patch_seed(seed, patch.index))


def refine_sharded(scene_block, cfg: MvsConfig, pb: PatchBatch,
                   neighbor_radius, is_seed: bool, rounds: int, patch, view,
                   seed: int = 0, final_filter: bool = True,
                   draws: Sequence[PsoDraws] | None = None,
                   generator: torch.Generator | None = None
                   ) -> lc.RefineResult:
    """``refine_batch`` over the layout. ``pb`` is the whole batch (the
    same on every rank; B divisible by the patch axis); ``scene_block`` is
    this rank's camera block (the whole scene with ``view=None``). Each
    patch rank refines its slice with ``refine_batch(view=view)``, its PSO
    drawing from the slice of ``draws`` (one ``PsoDraws`` per round for
    the whole batch) when given, else from ``generator`` (a stream the
    caller seeded from the patch index and continues across calls), else
    from a fresh stream of ``patch_seed(seed, patch.index)``. Returns the
    whole refined batch on every rank."""
    sl = _patch_slice(pb.capacity, patch)
    local = _map(lambda t: t[sl], pb)
    if draws is None and generator is None:
        generator = _generator(seed, patch, pb.device)
    res = lc.refine_batch(
        scene_block, cfg, local, neighbor_radius, is_seed, rounds,
        final_filter, generator=None if draws is not None else generator,
        draws=None if draws is None else [_slice_draws(d, sl) for d in draws],
        view=view)
    names = [f.name for f in dataclasses.fields(PatchBatch)]
    got = patch.all_gather_rows([getattr(res.batch, f) for f in names]
                                + [res.iterations])
    return lc.RefineResult(PatchBatch(**dict(zip(names, got))), got[-1])


def sharded_pso_refine(scene_block, cfg: MvsConfig, ref_cam, cam_mask, lod,
                       ray, lo, hi, init, patch, view, particle_num: int,
                       max_iteration: int, seed: int = 0) -> PsoResult:
    """The batched GLN-PSO patch optimisation over the layout
    (pais_mvs_tpu/parallel/sharded.py:57-94). Inputs are whole-batch
    ([B, ...], B divisible by the patch axis); each patch rank optimises
    its slice with the view-sharded fitness. Returns the whole batch's
    PsoResult on every rank."""
    sl = _patch_slice(ref_cam.shape[0], patch)
    fit_fn = (lambda pos, act: VF.fitness_view(
        scene_block, cfg, ref_cam[sl], cam_mask[sl], lod[sl], ray[sl], pos,
        view, active=act))
    res = gln_pso(fit_fn, lo[sl], hi[sl], init[sl],
                  particle_num=particle_num, max_iteration=max_iteration,
                  generator=_generator(seed, patch, lo.device))
    return PsoResult(*(patch.all_gather(t, 0) for t in res))
