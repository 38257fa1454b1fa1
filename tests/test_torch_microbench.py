"""PyTorch port: the microbench of the fitness kernel's inner loop (M,
``pais_mvs_tpu_torch/tools/microbench_kernel.py``) on the CPU.

The Pallas body of the JAX tool cannot run here (it uses ``pltpu.roll`` and
VMEM block specs), so the yardstick is a numpy transcription of body A's
matrix form (tools/microbench_kernel.py:69-92): the rolled, truncated box
slice in bf16 times the bf16 x-hat matrix [64, 1024], times the f32
y-hats, summed over rows and particles. Tolerance 1e-4 relative: the
transcription sums in float64 over all 64 columns and 80 rows, the port
in f32 over the four non-zero taps.

Variants (c) and (d) read each cell's tap footprint, staged and rebuilt
as bf16 quads; no kernel runs here, so ``run_grid_quads`` walks the same
data path in PyTorch (footprint rows at 16-byte column bounds, the quad
layout, one quad per tap) and must give ``run_grid_plain``'s bits.
"""

import functools

import ml_dtypes
import numpy as np
import pytest
import torch

from pais_mvs_tpu_torch.ops import cuda_fitness as CF
from pais_mvs_tpu_torch.tools import microbench_kernel as MB
import torch_parity  # noqa: F401  (one torch thread per worker)

CELLS = 10               # covers all 8 boxes and the wrap to box 0


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float64)


def body_a_matrix_form(box: np.ndarray, cells: int) -> np.ndarray:
    """tools/microbench_kernel.py:69-92 in numpy -> [cells, 1024]."""
    t = np.arange(MB.T, dtype=np.float32)
    k = np.arange(MB.KS, dtype=np.float32)[:, None]
    y = np.arange(MB.KY, dtype=np.float32)[:, None]
    v = np.float32(40.0) + np.float32(0.01) * t
    cw = np.maximum(np.float32(1.0) - np.abs(v[None, :] - y),
                    np.float32(0.0)).astype(np.float64)       # [80, T]
    out = np.zeros((cells, MB.T))
    for i in range(cells):
        X = box[i % box.shape[0]]
        for p in range(MB.P):
            bp = _bf16(np.roll(X, -(p % 17), axis=1)[:, :MB.KS])
            u = (np.float32(30.0) + np.float32(0.03) * t) + np.float32(p)
            rw = _bf16(np.maximum(np.float32(1.0) - np.abs(u[None, :] - k),
                                  np.float32(0.0)))           # [64, T]
            out[i] += ((bp @ rw) * cw).sum(0)
    return out


@functools.lru_cache(maxsize=None)
def _body_a(seed: int) -> torch.Tensor:
    return torch.from_numpy(body_a_matrix_form(
        MB.make_box(seed, "cpu").numpy(), CELLS))


def run_grid_quads(box: torch.Tensor, cells: int) -> torch.Tensor:
    """The data path of variants (c) and (d) in PyTorch: per cell, the
    footprint rows y_lo..y_hi at columns cw..cw+sw (what the bulk copies
    stage), the quads Q[y][c] = bf16 (X[y][c], X[y][c+1], X[y+1][c],
    X[y+1][c+1]) of csrc/microbench.cu's layout, then one quad per
    (pixel, particle) at (y0 - y_lo) qw + c0 - c_lo and (a)'s arithmetic
    in (a)'s order. -> [cells, 8, 128] f32."""
    fp = MB.tap_footprint()
    y_lo, y_hi, c_lo, c_hi = fp
    cw, sw, qh, qw = MB.quad_layout(fp)
    assert cw % 4 == 0 and sw % 4 == 0          # 16-byte bulk copies
    idx = torch.arange(cells) % box.shape[0]
    S = box[idx, y_lo:y_hi + 1, cw:cw + sw]                 # [n, rows, sw]
    X = S.to(torch.bfloat16).float()
    o = c_lo - cw
    Q = torch.stack([X[:, :-1, o:o + qw], X[:, :-1, o + 1:o + qw + 1],
                     X[:, 1:, o:o + qw], X[:, 1:, o + 1:o + qw + 1]],
                    -1).reshape(cells, qh * qw, 4)
    t = torch.arange(MB.T, dtype=torch.float32)
    v = MB.V0 + 0.01 * t
    y0 = torch.floor(v).long()
    wy0 = torch.clamp(1.0 - torch.abs(v - y0.float()), min=0.0)
    wy1 = torch.clamp(1.0 - torch.abs(v - (y0 + 1).float()), min=0.0)
    acc = torch.zeros((cells, MB.T), dtype=torch.float32)
    bf = lambda x: x.to(torch.bfloat16).float()
    for p in range(MB.P):
        u = MB.U0 + 0.03 * t + p
        k0 = torch.floor(u).long()
        wx0 = torch.where(k0 < MB.KS, bf(torch.clamp(
            1.0 - torch.abs(u - k0.float()), min=0.0)), 0.0)
        wx1 = torch.where(k0 + 1 < MB.KS, bf(torch.clamp(
            1.0 - torch.abs(u - (k0 + 1).float()), min=0.0)), 0.0)
        q = Q[:, (y0 - y_lo) * qw + k0 + p % 17 - c_lo]     # [n, T, 4]
        tmp0 = q[..., 0] * wx0 + q[..., 1] * wx1
        tmp1 = q[..., 2] * wx0 + q[..., 3] * wx1
        acc = acc + (tmp0 * wy0 + tmp1 * wy1)
    return acc.reshape(cells, 8, 128)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_twin_matches_body_a(seed):
    box = MB.make_box(seed, "cpu")
    got = MB.run_grid_plain(box, CELLS)
    assert got.shape == (CELLS, 8, 128) and got.dtype == torch.float32
    assert MB.max_rel_err(got.reshape(CELLS, MB.T).double(),
                          _body_a(seed)) <= 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_quad_path_matches_plain_and_body_a(seed):
    """The footprint -> quads -> one quad per tap path of (c) and (d) gives
    the plain twin's bits, and is within 1e-4 relative of body A."""
    box = MB.make_box(seed, "cpu")
    got = run_grid_quads(box, CELLS)
    assert torch.equal(got, MB.run_grid_plain(box, CELLS))
    assert MB.max_rel_err(got.reshape(CELLS, MB.T).double(),
                          _body_a(seed)) <= 1e-4


def test_tap_footprint_holds_every_tap():
    """Rows 40-51 and columns 30-102, and every tap of the plain twin's
    formula (all pixels and particles, in numpy f32) inside them, with
    both bounds reached."""
    fp = MB.tap_footprint()
    assert fp == (40, 51, 30, 102)
    t = np.arange(MB.T, dtype=np.float32)
    v = np.float32(MB.V0) + np.float32(0.01) * t
    y0 = np.floor(v).astype(np.int64)
    rows = np.concatenate([y0, y0 + 1])
    p = np.arange(MB.P)
    u = (np.float32(MB.U0) + np.float32(0.03) * t)[None, :] + \
        p[:, None].astype(np.float32)
    k0 = np.floor(u).astype(np.int64) + (p % 17)[:, None]
    cols = np.concatenate([k0 % MB.KX, (k0 + 1) % MB.KX])
    assert (rows.min(), rows.max(), cols.min(), cols.max()) == fp
    cw, sw, qh, qw = MB.quad_layout(fp)
    assert (cw, sw, qh, qw) == (28, 76, 11, 72)
    assert cw <= fp[2] and fp[3] < cw + sw


def test_tap_footprint_raises_when_taps_wrap():
    """Taps moved 200 columns right wrap past column 255: no quad layout."""
    with pytest.raises(ValueError, match="wrap"):
        MB.tap_footprint(u0=200.0)
    assert MB.tap_footprint(u0=150.0) == (40, 51, 150, 222)


def test_cpu_tensor_runs_the_plain_twin():
    """The wrapper dispatches by device: a CPU box runs the plain twin and
    launches nothing."""
    box = MB.make_box(2, "cpu")
    before = dict(CF.LAUNCHES)
    for v in MB.VARIANTS:
        assert torch.equal(MB.run_grid(box, 3, variant=v),
                           MB.run_grid_plain(box, 3))
    assert CF.LAUNCHES == before
    with pytest.raises(RuntimeError, match="no GPU"):
        MB.make_box(0)                    # the default device is the card


def test_bound_counts_operations():
    """At the bench's 5120 cells the FP32 work, not the 21.6 MB of memory
    traffic, bounds a call."""
    ms, by = MB.bound_ms()
    assert by == "operations"
    ops = MB.CELLS * MB.T * MB.P * MB.OPS_SAMPLE + MB.T * MB.P * \
        MB.OPS_WEIGHTS
    assert ms == pytest.approx(ops / 67e12 * 1e3)


def test_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    assert MB.main(["--reps", "1"]) == 2
