"""Microbench of the fitness kernel's inner loop on the card (M).

The Hopper counterpart of ``tools/microbench_kernel.py``'s ``run_grid``
(:46-62) with its body A, "the current design" (:69-92): over 5120 grid
cells (the bench workload's 1024 patches x 5 cameras), each of 30
particles bilinear-samples a box [80, 256] of the atlas into 1024 window
pixels, and the cell sums them. It is the yardstick of K1's inner loop
(gather pattern, particle loop, store) for a redesign of
``csrc/fitness.cu``. The kernels are ``csrc/microbench.cu``:

  (a) taps read straight from global memory, as K1 does today;
  (b) the cell's box staged once into shared memory with ``cp.async``;
  (c) only the cell's tap footprint (``tap_footprint``) staged by Hopper's
      bulk copy behind an mbarrier, rebuilt as bf16-rounded quads (one
      16-byte shared load per bilinear sample), particles unrolled;
  (d) (c) in persistent blocks (``persistent_grid``) with a two-stage
      ring: the next cell's footprint is copied while the current one is
      read.

All four compute the same bits; each is held to ``run_grid_plain`` and
timed. The TPU variants B-W of the JAX tool (rolls, MXU shapes, bf16 VPU
builds, slice hoisting) are TPU mechanism and have no Hopper meaning;
they are not ported.

    python -m pais_mvs_tpu_torch.tools.microbench_kernel [--reps N]

prints the card's name and power limit, then ms/call, us/cell and
us/particle for each variant (as the JAX tool's ``timeit``, :31-43), and
exits non-zero without a card or when a variant disagrees with the plain
version.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from pais_mvs_tpu_torch import resolve_device
from pais_mvs_tpu_torch.ops import cuda_fitness as CF

KY, KX = 80, 256       # box rows, columns
KS = 64                # columns the hat matrix spans
T = 1024               # window pixels per particle
P = 30                 # particles per cell
CELLS = 5120           # bench workload: B=1024 patches x C=5 views
NBOX = 8               # distinct boxes; cell i reads box i mod 8
U0, V0 = 30.0, 40.0    # u = U0 + 0.03 t + p, v = V0 + 0.01 t
# FP32 operations per (cell, pixel, particle): four taps times their two
# weights and the sums (tmp0, tmp1: 3 each; two weighted rows and the
# accumulation: 4). The hat weights depend on (pixel, particle) only and
# are counted once per (pixel, particle): OPS_WEIGHTS.
OPS_SAMPLE, OPS_WEIGHTS = 10, 14
VARIANTS = ("a", "b", "c", "d")
LABELS = {"a": "(a) taps from global/L2",
          "b": "(b) box in shared memory (cp.async)",
          "c": "(c) footprint by bulk copy, bf16 quads",
          "d": "(d) (c) persistent, two-stage ring"}
# H100 SXM data-sheet peaks (dense, at 700 W)
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
PLAIN_CHUNK = 512      # cells per step of the plain twin (bounds memory)


def make_box(seed: int = 0, device="cuda") -> torch.Tensor:
    """The [8, 80, 256] f32 boxes of uniform [0, 1) values (np.random.rand
    in the JAX tool), from ``seed``."""
    box = np.random.default_rng(seed).random((NBOX, KY, KX), np.float32)
    return torch.as_tensor(box, device=resolve_device(device))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def run_grid_plain(box: torch.Tensor, cells: int = CELLS) -> torch.Tensor:
    """Plain twin of the M kernels: the same function, tap by tap, in
    PyTorch; particles summed in order as the kernels do.
    box [nbox, 80, 256] f32 -> [cells, 8, 128] f32."""
    dev = box.device
    X = _bf16(box)
    t = torch.arange(T, dtype=torch.float32, device=dev)
    v = V0 + 0.01 * t
    y0 = torch.floor(v).long()
    wy0 = torch.clamp(1.0 - torch.abs(v - y0.float()), min=0.0)
    wy1 = torch.clamp(1.0 - torch.abs(v - (y0 + 1).float()), min=0.0)
    out = torch.empty((cells, T), dtype=torch.float32, device=dev)
    for s in range(0, cells, PLAIN_CHUNK):
        idx = torch.arange(s, min(s + PLAIN_CHUNK, cells), device=dev)
        Xc = X[idx % box.shape[0]]                            # [n, 80, 256]
        r0 = Xc[:, y0]                                        # [n, T, 256]
        r1 = Xc[:, y0 + 1]
        acc = torch.zeros((len(idx), T), dtype=torch.float32, device=dev)
        for p in range(P):
            u = U0 + 0.03 * t + p
            k0 = torch.floor(u).long()
            wx0 = torch.where(k0 < KS, _bf16(torch.clamp(
                1.0 - torch.abs(u - k0.float()), min=0.0)), 0.0)
            wx1 = torch.where(k0 + 1 < KS, _bf16(torch.clamp(
                1.0 - torch.abs(u - (k0 + 1).float()), min=0.0)), 0.0)
            c0 = ((k0 + p % 17) % KX)[None, :, None].expand(len(idx), T, 1)
            c1 = ((k0 + 1 + p % 17) % KX)[None, :, None].expand(len(idx), T,
                                                                 1)
            tap = lambda r, c: torch.gather(r, 2, c)[..., 0]
            tmp0 = tap(r0, c0) * wx0 + tap(r0, c1) * wx1
            tmp1 = tap(r1, c0) * wx0 + tap(r1, c1) * wx1
            acc = acc + (tmp0 * wy0 + tmp1 * wy1)
        out[idx] = acc
    return out.reshape(cells, 8, 128)


@functools.lru_cache(maxsize=None)
def tap_footprint(u0: float = U0):
    """(y_lo, y_hi, c_lo, c_hi): the rows and columns (inclusive) that the
    taps of the function read, over every pixel and particle, from the tap
    formula of ``run_grid_plain`` (rows y0 and y0 + 1, columns c0 and c1);
    (40, 51, 30, 102) for the function M computes. ``u0`` is the formula's
    column offset. Raises if a column pair wraps past column 255
    (c1 != c0 + 1), where the quad layout of variants (c) and (d) would be
    wrong."""
    t = torch.arange(T, dtype=torch.float32)
    v = V0 + 0.01 * t
    y0 = torch.floor(v).long()
    p = torch.arange(P)
    u = (u0 + 0.03 * t)[None, :] + p[:, None].float()          # [P, T]
    k0 = torch.floor(u).long() + (p % 17)[:, None]
    c0, c1 = k0 % KX, (k0 + 1) % KX
    if not torch.equal(c1, c0 + 1):
        raise ValueError(f"the taps wrap past column {KX - 1} (u0={u0}): "
                         f"the quad layout needs c1 = c0 + 1")
    return int(y0.min()), int(y0.max()) + 1, int(c0.min()), int(c1.max())


def quad_layout(footprint):
    """(cw, sw, qh, qw), as ``Layout`` in csrc/microbench.cu sizes them:
    the staged footprint rows start at column cw (a 16-byte bound) and are
    sw floats wide (a multiple of 4); the quads are [qh, qw], the quad of
    (y0, c0) at (y0 - y_lo, c0 - c_lo)."""
    y_lo, y_hi, c_lo, c_hi = footprint
    cw = c_lo & ~3
    return cw, ((c_hi + 4) & ~3) - cw, y_hi - y_lo, c_hi - c_lo


def smem_bytes(variant: str) -> int:
    """The dynamic shared memory of one block of ``variant``."""
    if variant in ("a", "b"):
        return 0 if variant == "a" else KY * KX * 4
    cw, sw, qh, qw = quad_layout(tap_footprint())
    stages = 1 if variant == "c" else 2       # footprint buffers
    # two mbarriers (16 B), the footprint buffers, one quad buffer
    return 16 + stages * (qh + 1) * sw * 4 + qh * qw * 16


@functools.lru_cache(maxsize=None)
def persistent_grid(footprint, device_index: int) -> int:
    """Variant (d)'s grid on card ``device_index``: the blocks one SM holds
    at once (the occupancy calculator at (d)'s shared memory) times the
    SMs."""
    CF.build_kernels(["microbench"])
    fn = ctypes.CDLL(str(CF._lib_path("microbench"))).pais_microbench_d_grid
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    grid = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = fn(*footprint, ctypes.byref(grid))
    if rc != 0:
        err = CF._LIBS["microbench_d"][1]
        raise RuntimeError(f"microbench_d's occupancy query failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return grid.value


def run_grid(box: torch.Tensor, cells: int = CELLS, variant: str = "a",
             grid=None) -> torch.Tensor:
    """M on the card (variant ``a``-``d``) for a CUDA ``box``; the plain
    twin for a CPU one. ``grid`` sets variant (d)'s blocks (default
    ``persistent_grid``; at most ``cells`` are launched).
    box [nbox, 80, 256] f32 -> [cells, 8, 128] f32."""
    if box.device.type == "cpu":
        return run_grid_plain(box, cells)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant}")
    if grid is not None and variant != "d":
        raise ValueError(f"grid is variant d's, not {variant}'s")
    if tuple(box.shape[1:]) != (KY, KX):
        raise ValueError(f"box must be [n, {KY}, {KX}], got "
                         f"{tuple(box.shape)}")
    args = [CF._check("box", box, torch.float32), box.shape[0], cells]
    if variant in ("c", "d"):
        if args[0] % 16:
            raise ValueError("box must be 16-byte aligned: variants c and d "
                             "bulk-copy its rows")
        fp = tap_footprint()
        args += fp
        if variant == "d":
            if grid is None:
                grid = persistent_grid(fp, box.device.index)
            args.append(min(grid, cells))
    out = torch.empty((cells, 8, 128), dtype=torch.float32,
                      device=box.device)
    CF._launch(f"microbench_{variant}", *args, out.data_ptr())
    return out


def sass_per_step() -> dict:
    """{variant: (instructions, {opcode: count})} per (pixel, particle) step
    of each kernel's tap loop, static counts from ``cuobjdump -sass`` of the
    built library: the innermost loop (a backward branch) that holds the
    blend's FMULs, its steps counted by its tap loads (four 4-byte loads a
    step in (a) and (b), one 16-byte quad in (c) and (d)). In (c) and (d)
    the particles are unrolled into the pixel loop, so their count holds
    the per-pixel work (1/30 of it a step) too."""
    CF.build_kernels(["microbench"])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(CF._lib_path("microbench"))],
                          check=True, capture_output=True, text=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"microbench_([a-d])_kernel", fn.split("\n", 1)[0])
        if m is None:
            continue
        ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", t.strip()))
               for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                      fn)]
        loops = []
        for addr, text in ins:
            b = re.match(r"BRA(?:\.\S+)?\s+0x([0-9a-f]+)", text)
            if b and int(b.group(1), 16) < addr:
                ops = [t.split()[0].split(".")[0] for a, t in ins
                       if int(b.group(1), 16) <= a <= addr]
                if "FMUL" in ops:
                    loops.append((addr - int(b.group(1), 16), ops))
        ops = min(loops)[1]
        loads = sum(op in ("LDG", "LDS") for op in ops)
        steps = loads / (4 if m.group(1) in "ab" else 1)
        out[m.group(1)] = (len(ops) / steps, {
            op: n / steps for op, n in collections.Counter(ops).items()})
    return out


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(|want|, 1)."""
    return float(((got - want).abs()
                  / torch.clamp(want.abs(), min=1.0)).max())


def bound_ms(cells: int = CELLS):
    """(least ms, "bytes" or "operations") for one call on the H100: the
    boxes read once and the output written once, against the FP32
    operations."""
    nbytes = NBOX * KY * KX * 4 + cells * T * 4
    ops = cells * T * P * OPS_SAMPLE + T * P * OPS_WEIGHTS
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def report(name: str, ms: float) -> str:
    per_cell = ms * 1e3 / CELLS
    return (f"{name:44s} {ms:8.4f} ms/call  {per_cell:7.4f} us/cell "
            f"{per_cell / P:7.5f} us/particle")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_kernel: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    box = make_box(0)
    plain = run_grid_plain(box)
    for v in VARIANTS:
        err = max_rel_err(run_grid(box, variant=v), plain)
        print(f"variant {v}: max relative error {err:.3g} against the plain "
              f"version")
        if not err <= 1e-4:
            print(f"microbench_kernel: variant {v} disagrees",
                  file=sys.stderr)
            return 1
    b_ms, b_by = bound_ms()
    print(report("plain PyTorch (tap form)",
                 time_ms(lambda: run_grid_plain(box), 3, 1)))
    for v in VARIANTS:
        print(report(LABELS[v], time_ms(lambda: run_grid(box, variant=v),
                                        args.reps)))
    print(f"bound {b_ms:.4f} ms ({b_by})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
