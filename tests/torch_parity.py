"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*):
the JAX package's PSO uniforms as the port's injectable ``PsoDraws``.

Importing this module also pins torch to one intra-op thread: the suite
runs in several pytest-xdist workers at once, and a full-width torch
thread pool in each oversubscribes the cores (the port's tests ran twice
as long that way)."""

import jax
import numpy as np
import torch

from pais_mvs_tpu_torch.ops.pso import PsoDraws

torch.set_num_threads(1)


def jax_draws(key, B, P, D, max_iteration, n_streams=4) -> PsoDraws:
    """The uniforms pais_mvs_tpu.ops.pso.gln_pso draws from ``key``
    (its splits at pso.py:142-144 and 227-228), as a PsoDraws."""
    k_pos, k_vel, key = jax.random.split(key, 3)
    pos = jax.random.uniform(k_pos, (B, P, D))
    vel = jax.random.uniform(k_vel, (B, P, D))
    steps = jax.random.uniform(jax.random.fold_in(key, 7),
                               (max_iteration, n_streams, B, P))
    return PsoDraws(*(torch.tensor(np.asarray(a)) for a in (pos, vel, steps)))


def refine_draws(key, rounds, B, P, max_iteration):
    """One PsoDraws per round of pais_mvs_tpu.ops.lifecycle.refine_batch,
    which hands gln_pso ``fold_in(key, round)`` (lifecycle.py:438)."""
    return [jax_draws(jax.random.fold_in(key, r), B, P, 3, max_iteration)
            for r in range(rounds)]


def concat_draws(per_shard):
    """One PsoDraws per round for a whole batch from the lists of its
    shards' (each shard's ``refine_draws``), shard after shard: the
    uniforms JAX's shard k draws under ``fold_in(key, k)`` land on the
    port's rows of patch rank k."""
    return [PsoDraws(torch.cat([d[r].pos for d in per_shard]),
                     torch.cat([d[r].vel for d in per_shard]),
                     torch.cat([d[r].steps for d in per_shard], 2))
            for r in range(len(per_shard[0]))]
