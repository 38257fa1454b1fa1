"""PyTorch port: pose-refinement bundle adjustment
(``pais_mvs_tpu_torch/ops/bundle.py``) against ``pais_mvs_tpu/ops/bundle.py``
on tests/test_bundle.py's problems, the same numpy inputs fed to both.

Bars, and why. The LM steps solve the Schur-reduced camera system in f32 in
both packages; after the Jacobi scaling its condition number is ~1e7 here,
because the scale gauge is held only by the damping. So the step moves
along the scale direction by an amount each package's f32 summation order
decides: JAX's own first step is ~9% off the float64 solution, the port's
~15%. What the bars hold:
  * the pieces of one step (the Schur system, the point blocks, the
    rotation update) to 1e-5 of each piece's largest entry, and the
    preconditioned solve in float64 against numpy to 1e-9;
  * the RMS history: the start (residuals only) to 1e-5 relative plus
    1e-5 px (the f32 floor of a projection at these depths); every later
    entry within 25% of JAX's plus 5e-4 px: below ~5e-4 px the history is
    the f32 error along the scale direction (JAX's second step reads
    4.0e-4 px where float64 reads 1.6e-4), and a wrong Jacobian would stall
    far above it; both converging;
  * the final rotations to 1e-4 and the centres to 1e-4 after aligning the
    unobservable scale about the pinned camera, as tests/test_bundle.py
    compares;
  * the sharded solve (two gloo ranks, tracks split and padded) against the
    port's single-rank solve and JAX's 8-device shard_map at
    tests/test_bundle.py:79's bars, every rank returning the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu.ops import bundle as JB
from pais_mvs_tpu.parallel.mesh import PATCH_AXIS, make_mesh
from pais_mvs_tpu_torch.ops import bundle as TB
from test_bundle import _problem
from torch_view_worker import run_workers

CASES = {"perturbed": {}, "zero_noise": dict(noise_rot=0.0, noise_c=0.0,
                                             noise_p=0.0)}


def _host(prob):
    return [np.asarray(x) for x in prob]


def _torch(fields) -> TB.BaProblem:
    return TB.BaProblem(*(torch.tensor(x) for x in fields))


def _aligned(c, ref):
    """``c`` after scaling about camera 0 onto ``ref``'s scale."""
    s = np.linalg.norm(ref[1] - ref[0]) / np.linalg.norm(c[1] - c[0])
    return (c - c[0]) * s + ref[0]


def test_step_pieces_match_jax():
    prob, _ = _problem()
    want = JB._assemble(*prob, 1e-4)
    got = TB._assemble(*_torch(_host(prob)), 1e-4)
    for name, a, b in zip(("S", "rhs", "Hpp_inv", "bp", "W", "sse", "n"),
                          want, got):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-5 * np.abs(a).max(), err_msg=name)
    w = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    for scale in (0.1, 1e-13):
        np.testing.assert_allclose(
            TB._exp_so3(torch.tensor(w * scale)).numpy(),
            JB._exp_so3(jnp.asarray(w * scale)), atol=1e-6, rtol=0)
    S = np.asarray(want[0], np.float64) + 1e-4 * np.eye(24)
    S[:6], S[:, :6] = 0.0, 0.0
    S[:6, :6] = np.eye(6)
    rhs = np.asarray(want[1], np.float64)
    rhs[:6] = 0.0
    y = TB._solve_preconditioned(torch.tensor(S), torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(y, np.linalg.solve(S, rhs), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_adjust_matches_jax(case):
    prob, true = _problem(**CASES[case])
    iters = 8 if case == "perturbed" else 3
    want = JB.bundle_adjust(prob, num_iters=iters, damping=1e-4)
    got = TB.bundle_adjust(_torch(_host(prob)), num_iters=iters,
                           damping=1e-4)
    hw, hg = np.asarray(want.rms_history), got.rms_history.numpy()
    np.testing.assert_allclose(hg[0], hw[0], rtol=1e-5, atol=1e-5)
    assert np.all(np.abs(hg - hw) <= 0.25 * np.maximum(hg, hw) + 5e-4), \
        (hg, hw)
    if case == "perturbed":
        assert hg[0] > 1.0 and hg[-1] < 1e-3, hg
    else:       # stays put
        assert hg[-1] <= hg[0] + 1e-3 and hg[-1] < 0.02, hg
    np.testing.assert_allclose(got.R.numpy(), want.R, atol=1e-4, rtol=0)
    c, cw = got.center.numpy(), np.asarray(want.center)
    np.testing.assert_allclose(c[0], np.asarray(prob.center)[0], atol=1e-6)
    np.testing.assert_allclose(_aligned(c, cw), cw, atol=1e-4, rtol=0)


def test_bundle_adjust_sharded_matches(tmp_path):
    """Two gloo ranks, tracks split evenly (64) and padded (63), against
    the port's single-rank solve and JAX's shard_map over 8 devices."""
    kw = dict(num_iters=5, damping=1e-4)
    prob, _ = _problem(M=64)
    problems = {"even": _host(prob),
                "padded": [x[:63] if i >= 4 else x
                           for i, x in enumerate(_host(prob))]}
    ranks = run_workers("ba", 2, tmp_path, {"problems": problems, "kw": kw})
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    jax8 = JB.bundle_adjust_sharded(prob, make_mesh((8, 1)), PATCH_AXIS,
                                    **kw)
    for name, fields in problems.items():
        single = TB.bundle_adjust(_torch(fields), **kw)
        r = {k[len(name) + 1:]: v for k, v in ranks[0].items()
             if k.startswith(name + "_")}
        assert r["points"].shape == fields[4].shape
        refs = [(single.R.numpy(), single.center.numpy(),
                 single.rms_history.numpy())]
        if name == "even":
            refs.append((np.asarray(jax8.R), np.asarray(jax8.center),
                         np.asarray(jax8.rms_history)))
        assert r["rms_history"][-1] < 1e-3
        for R, c, h in refs:
            assert h[-1] < 1e-3
            np.testing.assert_allclose(_aligned(r["center"], c), c,
                                       atol=2e-3)
            np.testing.assert_allclose(r["R"], R, atol=2e-3)
