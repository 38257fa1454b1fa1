"""PyTorch port: the microbench of the fitness kernel's inner loop (M,
``pais_mvs_tpu_torch/tools/microbench_kernel.py``) on the CPU.

The Pallas body of the JAX tool cannot run here (it uses ``pltpu.roll`` and
VMEM block specs), so the yardstick is a numpy transcription of body A's
matrix form (tools/microbench_kernel.py:69-92): the rolled, truncated box
slice in bf16 times the bf16 x-hat matrix [64, 1024], times the f32
y-hats, summed over rows and particles. Tolerance 1e-4 relative: the
transcription sums in float64 over all 64 columns and 80 rows, the port
in f32 over the four non-zero taps.
"""

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


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_twin_matches_body_a(seed):
    box = MB.make_box(seed, "cpu")
    got = MB.run_grid_plain(box, CELLS)
    assert got.shape == (CELLS, 8, 128) and got.dtype == torch.float32
    want = torch.from_numpy(body_a_matrix_form(box.numpy(), CELLS))
    assert MB.max_rel_err(got.reshape(CELLS, MB.T).double(), want) <= 1e-4


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
