"""PyTorch port: batched GLN-PSO against the JAX package's ``gln_pso``.

``jax.random`` cannot be reproduced in torch, so the JAX run's own uniforms
(the key splits of pais_mvs_tpu/ops/pso.py:142-144, 227-228) are injected
into the port as ``PsoDraws``, on the landscapes of tests/test_pso.py.

Tolerances, and why they are not exact: XLA's CPU backend contracts
multiply-adds into FMAs (``jit(a*b + c)`` rounds once), eager torch rounds
twice, so the velocity update differs by an ulp from the FIRST step on,
and the swarm's compare/argmin chain amplifies that. It stays inside a
converged swarm's spread (convergence threshold 0.01):
  * gbest_fit to 1e-6 absolute (measured ~2e-7 on these landscapes);
  * gbest to 1e-3 absolute (measured 6e-4 on the flat bowl bottoms);
  * iteration counts equal for >= 90% of swarms and never more than one
    apart (measured: one swarm of 30 off by one).
With torch's own generator the convergence assertions of tests/test_pso.py
hold, and the chunked early exit is bit-identical to the fixed loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pais_mvs_tpu.ops.pso import gln_pso as j_pso
from pais_mvs_tpu_torch.ops.pso import gln_pso as t_pso
from torch_parity import jax_draws


def _bowl(opt_np):
    jo, to = jnp.asarray(opt_np), torch.tensor(opt_np)
    return (lambda pos: jnp.sum((pos - jo[:, None, :]) ** 2, axis=-1),
            lambda pos, act: ((pos - to[:, None, :]) ** 2).sum(-1))


def _rastrigin():
    return (lambda pos: (pos[..., 0] - 0.5) ** 2
            + 0.3 * jnp.sin(8 * pos[..., 0]) ** 2,
            lambda pos, act: (pos[..., 0] - 0.5) ** 2
            + 0.3 * torch.sin(8 * pos[..., 0]) ** 2)


def _case(name):
    """(jax fitness, torch fitness, lo, hi, init, key, P, T) of each
    tests/test_pso.py landscape."""
    if name == "bowls":
        B, D = 16, 3
        opt = np.random.default_rng(0).uniform(-1, 1, (B, D)).astype(
            np.float32)
        return (*_bowl(opt), np.full((B, D), -2.0, np.float32),
                np.full((B, D), 2.0, np.float32), None, 0, 16, 60)
    if name == "incumbent":
        B, D = 4, 2
        opt = np.asarray([[0.3, -0.4]] * B, np.float32)
        return (*_bowl(opt), np.full((B, D), -1.0, np.float32),
                np.full((B, D), 1.0, np.float32), opt, 1, 6, 10)
    if name == "early_stop":
        opt = np.zeros((2, 2), np.float32)
        lo = np.asarray([[-1e-4, -1e-4], [-2.0, -2.0]], np.float32)
        return (*_bowl(opt), lo, -lo, None, 2, 8, 30)
    if name == "multimodal":
        B = 8
        return (*_rastrigin(), np.full((B, 1), -3.0, np.float32),
                np.full((B, 1), 3.0, np.float32), None, 3, 24, 80)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["bowls", "incumbent", "early_stop",
                                  "multimodal"])
def test_injected_jax_draws_match_jax(name):
    jfit, tfit, lo, hi, init, seed, P, T = _case(name)
    key = jax.random.PRNGKey(seed)
    B, D = lo.shape
    a = j_pso(jfit, jnp.asarray(lo), jnp.asarray(hi),
              None if init is None else jnp.asarray(init), key,
              particle_num=P, max_iteration=T)
    b = t_pso(tfit, torch.tensor(lo), torch.tensor(hi),
              None if init is None else torch.tensor(init),
              particle_num=P, max_iteration=T,
              draws=jax_draws(key, B, P, D, T))
    np.testing.assert_allclose(b.gbest_fit.numpy(), np.asarray(a.gbest_fit),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.gbest.numpy(), np.asarray(a.gbest),
                               rtol=0, atol=1e-3)
    di = np.abs(b.iterations.numpy() - np.asarray(a.iterations))
    assert di.max() <= 1 and (di == 0).mean() >= 0.9, di


def test_own_generator_convergence():
    """tests/test_pso.py's assertions, with torch.Generator draws."""
    g = torch.Generator().manual_seed(0)
    run = lambda name, **kw: (lambda c: t_pso(
        c[1], torch.tensor(c[2]), torch.tensor(c[3]),
        None if c[4] is None else torch.tensor(c[4]),
        particle_num=c[6], max_iteration=c[7], generator=g, **kw))(
            _case(name))
    opt = np.random.default_rng(0).uniform(-1, 1, (16, 3)).astype(np.float32)
    res = run("bowls")
    assert np.abs(res.gbest.numpy() - opt).max() < 0.05
    assert float(res.gbest_fit.max()) < 0.01
    res = run("incumbent")
    np.testing.assert_allclose(res.gbest.numpy(), [[0.3, -0.4]] * 4,
                               atol=1e-6)
    np.testing.assert_allclose(res.gbest_fit.numpy(), 0.0, atol=1e-9)
    it = run("early_stop").iterations.numpy()
    assert it[0] < it[1]
    assert np.median(run("multimodal").gbest_fit.numpy()) < 0.05


@pytest.mark.parametrize("scale,seed", [(2.0, 10), (1e-4, 11)])
def test_exit_chunk_bit_identical(scale, seed):
    """The chunked early exit is BIT-identical to the fixed loop (frozen
    swarms never move), for chunks that divide, do not divide and exceed
    max_iteration; a dead swarm (active0 False) never steps."""
    B, D = 12, 3
    opt = torch.tensor(np.random.default_rng(4).uniform(-1, 1, (B, D)),
                       dtype=torch.float32)
    fit = lambda pos, act: ((pos - opt[:, None, :]) ** 2).sum(-1)
    lo = torch.full((B, D), -scale)
    hi = torch.full((B, D), scale)
    act0 = torch.tensor([True, False] * (B // 2))
    draws = jax_draws(jax.random.PRNGKey(seed), B, 8, D, 25)
    base = t_pso(fit, lo, hi, None, 8, 25, draws=draws, active0=act0)
    for chunk in (5, 7, 25, 40):
        res = t_pso(fit, lo, hi, None, 8, 25, draws=draws, active0=act0,
                    exit_chunk=chunk)
        for x, y in zip(base, res):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert not base.iterations.numpy()[1]
