#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pais_mvs_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero on failure (nothing is caught):
  1. the card's name and power limit; the kernels' build from ``csrc/``
     (one ``nvcc`` per source, all started together);
  2. K1 (fused fitness) against its plain PyTorch twin at bench.py's
     selftest shape (256 patches x 16 particles, wide noise) on the
     synthetic bench scene, the real-photo pawn-rig scene and a 12-camera
     synthetic rig, r in {3, 6, 15, 24}; P in {1, 7, 30} at r in {3, 15};
     a third of the swarms inactive, every swarm inactive, no valid
     particle: exact BIG set, |err| <= 1e-4 (relative above 1);
  3. K2 (warped-window sampler, NCC mode) against its plain twin on the
     three scenes, r in {3, 6, 15, 24}, on and off the surface, and with
     every camera masked: same ok set, 1e-5 (relative above 1);
  4. the view fitness's two kernels, A (``view_moments``: per window
     pixel, the camera block's valid-sample sum, its invalid visible
     cameras and the reference windows) and B (``view_deviation``: the sum
     of |sample - mean|), against their plain twins at the selftest shape:
     both scenes on camera blocks of 5 and 1, the 12-camera rig whole, r in
     {3, 6, 15, 24}, the edge plane on and off, a third of the swarms
     inactive and a third of the reference cameras not owned; then every
     swarm inactive and no valid particle: A's counts and reference planes
     equal, its sums and B to 1e-5 (relative above 1);
  5. the main path: ``refine_batch`` in seed mode, one round, at the full
     bench.py workload (5 cameras at 640x480, r=15, 15 particles x 30
     iterations doubled for seeds, B=1024, maxLOD 6); the launch counts of
     that run (K1 = 61, K2 = 1, no other), bench.py's quality bar (accepted
     > 50%, median surface distance < 0.003), and refined patches/s timed
     with CUDA events after a warm-up, with peak device memory; K1's
     inputs of the round's 31st evaluation are kept for phase 14;
  6. the same slice on the card and on the CPU (plain twins) with the same
     PSO draws on a small batch: they must agree;
  7. bench.py's real-photo pawn-rig gate (2 rounds: accepted > 40%,
     median < 2.5e-3);
  8. the seed-stage ``Reconstructor`` end to end, writing a PLY and
     reading it back;
  9. the view-sharded fitness through a real NCCL process group of world
     size 1 (A, one psum, B, a second psum, the torch weights) against flat
     K1 on the same inputs, both scenes: exact BIG set, 1e-4 (relative
     above 1);
 10. the view path at full width: the bench workload's seed round through
     ``parallel.sharded.refine_sharded`` at dp=1, vp=1; launch counts
     (A = 61, B = 61, K2 = 1, K1 = 0; A's and B's inputs of the round's
     31st evaluation are kept for phase 14), bench.py's bar, the round
     timed beside phase 5's flat round, with peak device memory;
 11. the real-photo gate through the view path (2 rounds);
 12. vp=5 on the one card: 5 gloo ranks, one camera each (each builds its
     camera block from the host pyramids), B=64: the view fitness against
     flat K1 (exact BIG set, 1e-4), and the refined batch against a vp=1
     run with the same PSO draws (valid agreement >= 0.95, median centre
     difference <= 1e-4), every rank returning the same bits;
 13. M, the microbench of K1's inner loop
     (``python -m pais_mvs_tpu_torch.tools.microbench_kernel``): the four
     variants ((a) taps from L2, (b) the box by ``cp.async``, (c) the tap
     footprint by bulk copy as bf16 quads, (d) (c) persistent with a
     two-stage ring) against the plain twin (1e-4 relative; each one's
     max |err| printed), then timed in turns (five rounds of a, b, c, d,
     d1, d1, d, c, b, a, d1 being (d) with one cell per block; median
     and IQR of the ten times each) beside the bound
     and ``grid_sample`` on the bf16-rounded boxes at the same 5120 x 1024
     x 30 coordinates, summed over particles (sampling only, not the same
     function: no bf16 hat weights, no 64-column clip); each variant's
     registers and spills from ``-Xptxas -v``, its shared memory and its
     tap loop's SASS instructions per (pixel, particle) step
     (``cuobjdump -sass``);
 14. each kernel's time at the main paths' shapes (K1, A and B on the
     round's first evaluation and on its 31st), beside its plain twin's,
     its roofline bound and, for K2, A and B, ``grid_sample`` on the same
     coordinates (for A and B: sampling only); then one whole
     ``fitness_view`` evaluation (device time, both kernels and both
     psums), the view path's like-for-like yardstick; printed as one
     ``{"kernels": [...]}`` line. ``ms`` is device time: the timed
     launches wait behind a ``torch.cuda._sleep`` that outlasts the host's
     enqueue, so the CUDA events around them bracket device work only;
     ``host_ms`` is the host's cost per wrapper call; ``plain_ms`` is what
     the plain twin's caller waits, host time included;
 15. ``refine_batch`` in the expansion mode that ``Reconstructor.expand``
     runs (normal bounds narrowed around the parent's, P and T not doubled)
     on the card and on the CPU with the same draws on phase 6's parents
     (phase 6's bars), then the launches of one full-width expansion chunk
     at bench.py's shape (K1 = 31, K2 = 1, no other) and its time;
 16. the port's main path as a user runs it: ``cli.main(["-r", ...])`` in
     this process on the pawn rig's real photograph at 2x (1280x960, five
     cameras, 300 seeds; tools/dist_realistic_2k.py's configuration) from
     PNG files, an NVM and a config.txt: seed refinement, the wavefront
     expansion and the writers. Gates: accepted seeds > 40%, the cloud >=
     20x the accepted seeds, median surface distance < 2.5e-3, every
     artifact written, exp.mvs read back with stats.json's live count,
     ``expansion_device_s`` (the refines' launch-to-completion spans by
     CUDA events) <= ``expansion_s``, K1, K2 and every kernel of the
     scene build (``csrc/pyramid.cu``: the CLI builds its scene on the
     card) launched and no other kernel ("the path's kernels" below), the
     cloud exactly the recorded one (153 seeds accepted, 11,308 patches,
     median 0.001573); prints refines/s and peak device memory. Then K1 and K2
     against their plain twins at this path's shapes: the engine's own
     scene and configuration, built from the files as the CLI builds
     them, and 1024 of the rig's seeds prepared (the same render with
     more seeds; its images equal the files'), at P=8 (expansion chunks)
     and P=16 (seed rounds), and with the rows' LOD cycled through every
     band of the atlas, phases 2-3's tolerances; and the expansion's
     device-busy share: the same seeds and expansion once more in this
     process under ``torch.profiler`` (CUDA activity only), the union of
     the device's activity intervals over the expansion's wall time;
 17. ``cli.main(["-f", "exp.mvs"])`` on phase 16's output: every artifact
     written; the median after the three structural filters no worse than
     the expansion's and < 2.5e-3; each filter's removals and
     neighborPatchFiltering's "avg neighbours" are printed, not gated.
 18. feature seeding at full width on phase 16's scene (1280x960, five
     cameras): ``generate_seed_patches`` twice on the card (bit-equal) and
     once on the CPU (the same seed count and camera sets, centres within
     1e-4); the count within 5% of the JAX package's 363 and the median
     surface distance < 1e-3; the device stages' times; then
     ``cli.main(["-r", "nopts.nvm"])`` twice on phase 16's PNGs and config
     with an NVM written without points (feature-seeded): exp.mvs
     bit-equal across the two runs, and phase 16's ``-r`` once more,
     bit-equal to phase 16's exp.mvs; phase 16's gates (accepted > 40%,
     the cloud >= 20x, median < 2.5e-3), the path's kernels;
 19. ``bundle_adjust`` on the rig's 300 tracks with cameras 1-4 perturbed
     (numpy seed 0: rotation N(0, 0.005), centre N(0, 0.01)) on the card
     and on the CPU: the start of the RMS history to 1e-5 relative, the
     final RMS < 1e-3 px on both, R and the scale-aligned centres within
     1e-4 (the intermediate RMS values hang on f32 summation order, so
     they are printed, not gated); ms per LM iteration;
     ``bundle_adjust_sharded`` through an NCCL world of 1 bit-equal to
     ``bundle_adjust``; then ``cli.main(["-r", nvm, "-b"])``: the RMS line,
     every artifact, phase 16's gates, the path's kernels;
 20. ``cli.main(["-v", "exp.mvs", "--patch-id", N, "--reoptimize",
     "--profile", DIR])`` on phase 16's output: every artifact (snapshot
     PLY, HTML viewer, the before and after PNGs) and a trace file in DIR,
     the re-optimised patch printed with its fitness before and after;
     ``warped_windows`` on the card against the CPU (same NaN and valid
     sets, within 0.1 of 255 intensity levels, ``WINDOW_TOL``); K1 and K2
     against their twins at B = 1 (the ``--reoptimize`` shape), phases
     2-3's tolerances;
 21. ``cli.main(["-a", "exp.mvs"])``: animate.ply holds exp.mvs's live
     patches with ``order`` 0..N-1 (scaled to [0, 1]);
 22. ``cli.main(["-r", nvm, "--distributed-expansion"])`` in this process
     on phase 16's files: the SPMD expansion in an NCCL world of one.
     Phase 16's gates, the path's kernels, and the
     cloud against phase 16's: mutual agreement at half a cell >= 0.65
     each way and the count ratio in [0.7, 1.43]
     (tests/test_engine_distributed.py::test_expand_distributed_
     realistic_parity's absolute bars); prints the expansion's time,
     rounds, spills, refines/s and peak device memory;
 23. dp=4: four processes of ``python -m pais_mvs_tpu_torch.cli -r ...
     --distributed-expansion --mesh-shape 4,1 --coordinator localhost:PORT
     --num-processes 4 --process-id I -o DIR_I`` (gloo, all on card 0,
     joined with a deadline, killed and reaped on expiry): every process
     exits 0 and logs the data-parallel seed refine, the four exp.mvs are
     bit-equal, and phase 22's gates hold with phase 22's cloud as the
     yardstick;
 24. vp=5: five gloo ranks on card 0 (``chip_smoke.py --dist-rank``), each
     building the CLI's Reconstructor on phase 16's files with one camera
     block, run the seed stage and ``expand_distributed`` on the (1, 5)
     mesh for ``DIST_VP_ROUNDS`` rounds; this process runs the same at
     vp=1 (flat K1, an NCCL world of one) with the same PSO streams. Every
     rank's arena bit-equal; the seed stages bit-equal to vp=1's; the
     first round's accepted rows against vp=1's (agreement >= 0.95,
     median centre difference <= 1e-4 over rows both accept: phase 12's
     bars) and the clouds after the last round >= 0.9 mutual agreement
     at half a cell; inside the expansion A, B and K2 launched and K1 not;
     on rank 0, A, B and K2 against their plain twins (phase 4's and
     phase 3's tolerances) on the arguments of their first call inside
     the expansion (the scale-2 atlas's one-camera block, the refine's
     rows of round 0).
 25. the refine as CUDA graphs (``ops/graphs.py``), graphed against
     eager at the same generator seeds: (a) the flat seed round at the
     bench workload, (c) phase 15's expansion chunk and (b) the view round
     through an NCCL world of one, each the key's first call (eager, then
     the capture) and two replays, bit-equal in every field with the eager
     round's launches per call; (f) capture time per key, the pool's bytes
     and peak memory; (e) ten alternating eager/graphed pairs of the flat
     round, the chunk and the view round (CUDA events, median and IQR)
     and one profiled call each way (device busy share); (d)
     ``cli.main(["-r", ...])`` on phase 16's files eager
     (``Reconstructor(graphs=False)``) and graphed in turns, twice each: exp.mvs byte-equal to phase 16's, the same
     launch totals and the logged counts (graphed: 1-6 captures, no eager
     refine; eager: no capture); (g) each run's expansion wall, the
     refines' spans and the host's time inside ``_refine_all_async``.
     Phase 16's ``-r`` and every later one run graphed (the default).
 26. ``psoExitChunk = 10``: the capture holds the fixed loop, which
     gives the early exit's bits; graphed against the eager refine with
     the exit and with the fixed loop at the same seeds (the key's first
     call and two replays; every field and the iterations equal, a
     replay's launches the fixed loop's): (a) the flat seed round at the
     bench workload, with ten alternating pairs; (b) the expansion chunk
     with the normal cone narrowed to +-pi/300, where every swarm freezes
     early: the eager exit launches fewer K1 than the fixed loop; (c) the
     view round through an NCCL world of one; (d)
     ``cli.main(["-r", nvm, "--distributed-expansion"])`` eager and
     graphed in turns, twice each (``expand_step`` refines its whole
     budget in one replayed call): every exp.mvs byte-equal to phase
     22's, the graphed runs logging no eager refine, phase 16's gates and
     phase 22's agreement with phase 16; each run's wall,
     ``dist_device_s`` and its split into the refines' spans and the
     rest.
 27. the main path at its first real image size:
     ``pais_mvs_tpu_torch.tools.gpu_4k_run`` (the counterpart of the JAX
     package's tools/tpu_4k_run.py) runs ``cli.main(["-r", ...])`` in this
     process on an 8-camera 4096x3072 curved synthetic scene (400 seeds,
     r=15, PSO 15 x 30, maxLOD 8, cellSize 16), the expansion capped at 24
     rounds. The scene is rendered and written (PNG, NVM, config.txt) by
     a child process (``chip_smoke.py --render-4k DIR``) started in phase
     1, joined here with a deadline. Gates: phase 16's, >= 0.9 x 400 seeds
     accepted, the cloud within [0.7, 1.43] x the JAX record's 69,954
     patches, median surface distance <= 3.1e-4 (1.5x its 2.04e-4), K1
     and K2 and the scene build's kernels launched and no other kernel,
     the cloud exactly the recorded one (399 seeds, 69,940 patches,
     median 1.8799459905110405e-4, 377,352 refines), no eager refine;
     the tool's dict (each stage's seconds, the scene build's split into
     NVM load and PNG decode, undistortion, uploads, kernels by CUDA
     events and the rest, autosaves, scene bytes, peak device memory,
     graph captures and pool, the card) is printed. Then K1 and K2
     against their twins on the run's own scene and configuration
     (``check_r_shapes`` on the scene's 400 seeds at P=15 and 30, and
     with the rows' LOD cycled through every band of the atlas), phases
     2-3's tolerances.
 28. the scene build on the card (``build_scene``: the kernels of
     ``csrc/pyramid.cu``) against the CPU's (their plain twins) from the
     same images: the pawn rig at 2x (phase 16's five 1280x960 images and
     configuration) and two of phase 27's 4096x3072 cameras (its PNGs,
     NVM and config.txt): every atlas, dims, yoff and the colour plane
     bit-equal; each build's seconds, the card's split and its device
     memory (the scene's, and the build's peak). Then each
     kernel at the 4K camera's shapes (level 0; the resample's passes at
     level 1; the two scans also on the window moments) against its twin
     on CPU copies of the same inputs, bit-equal, with its device time,
     the twin's host time, ``torch.cumsum`` on the card beside the scans,
     and its bound.
 29. K1 past its 32-camera tile on the 312-view hemisphere rig of the
     ``temple-r`` cell (``benchmark/scenes/hemisphere_object.py`` at
     640x480, r=15, PSO 15 x 30): against its plain twin with each seed's
     own views (up to ~110), each row's 33 best-facing cameras and every
     camera of the rig (phase 2's tolerances); the launches of one
     expansion-mode refine of 1024 rows (K1 31, K2 1, no other); K1's
     device time at B=1024, P=15 against the cameras a row sees (8, 32,
     33, 64, 90, 160), each held to the twin on 64 rows, with its share of
     the FP32 bound. ``chip_smoke.py --many-views`` runs this phase alone.
In the ``kernels`` line, K1's and K2's ``launches`` are phase 16's (this
slice's main path), beside ``launches_seed_round`` (phase 5),
``launches_expansion_chunk`` (phase 15), ``launches_features_r`` (phase
18's first -r), ``launches_refine_poses_r`` (phase 19's -r -b),
``launches_reoptimize`` (phase 20's -v) and ``launches_dist_r`` (phase
22's -r --distributed-expansion), ``launches_4k`` (phase 27's -r at
4K), ``launches_many_views`` (phase 29's refine; its table under
``many_views``); A's and B's are phase 10's;
``launches_dist_vp`` of A, B and K2 are rank 0's inside phase 24's
expansion.
Each kernel's ``max_abs_err`` is the largest of every check of it,
``max_abs_err_r`` that of the checks at phase 16's shapes alone,
``max_abs_err_b1`` that of phase 20's checks at B = 1,
``max_abs_err_dist_vp`` that of phase 24's check inside the expansion and
``max_abs_err_4k`` that of phase 27's checks at the 4K run's shapes,
``max_abs_err_many_views`` that of phase 29's.
M's entries (``microbench_a`` .. ``_d``, launches from phase 13's tool
run) add ``ms_iqr``, ``registers``, ``spill_bytes``, ``smem_bytes``,
``grid`` and ``sass_per_step``; their ``library_ms`` is sampling only.
The scene build's entries (``pyramid_*``; they replace no Pallas kernel)
take ``launches`` from phase 16 and ``launches_4k`` from phase 27, their
times, errors and bounds from phase 28; the scans add ``ms_moments`` (the
window moments' pair of planes) and their ``library_ms`` is
``torch.cumsum`` on one float64 plane.
The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the package beside this script, it exits non-zero with no result.
"""

import functools
import json
import os
import pickle
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12        # outside the tensor cores

# FP32 operations per (window pixel, visible camera) sample and per window
# pixel, counted from the kernels' arithmetic: homography 3 rows (6 mul +
# 6 add) + 2 divisions; fx/fy and 1-fx/1-fy (4); bilinear 8 mul + 3 add;
# mean 1 add; SAD sub + add (2) -> 32 per K1 sample (K2: the first 29).
# Per K1 pixel: window coordinates 2, mean/SAD divisions 2, difference
# weight 4 (mul, div, exp, mul), gradient weight 4 when enabled,
# foreground mask 1, sums 3.
K1_OPS_SAMPLE, K1_OPS_PIXEL, K1_OPS_GRAD = 32, 12, 4
K2_OPS_SAMPLE = 29
# the view kernels, per (window pixel, active camera) sample: K2's 29, then
# A's sum (1), B's subtraction, absolute value and sum (3); per window
# pixel, A's reference lookup: window coordinates (2 adds) and their
# rounding (2)
VIEW_A_OPS_SAMPLE, VIEW_B_OPS_SAMPLE = 30, 32
REF_OPS_PIXEL = 4


def child_pids() -> list:
    """The processes (zombies included) whose parent is this one, read
    from /proc."""
    me, kids = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            kids.append(int(d))
    return kids


def stop_children() -> list:
    """Kill and reap every child process still there; returns their
    command lines."""
    stopped = []
    for pid in child_pids():
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = "?"
        try:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
        stopped.append(f"{pid} {cmd.strip()}")
    return stopped


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    stop_children()
    sys.exit(code)


def log(msg: str):
    print(msg, flush=True)


def pyramid_entries() -> list:
    """The scene build's kernels (csrc/pyramid.cu)."""
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    return [e for e, (src, _) in CF.ENTRIES.items() if src == "pyramid"]


def path_launch_gate(label: str, launches: dict,
                     kernels=("fitness", "sampler")):
    """Fails unless each of ``kernels`` and every kernel of the scene build
    (the CLI builds its scene on the card) launched at least once, and no
    other kernel did."""
    want = set(kernels) | set(pyramid_entries())
    if any(launches[k] for k in launches if k not in want) or \
            not all(launches[k] for k in want):
        fail(f"{label} launched {launches}: {', '.join(sorted(want))} each "
             f"at least once and no other kernel expected")


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms() -> float:
    """The rate of ``torch.cuda._sleep`` on this card (cycles per ms),
    measured once with CUDA events."""
    import torch
    cycles = 20_000_000
    torch.cuda._sleep(cycles // 10)                           # warm-up
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(cycles)
    e1.record()
    e1.synchronize()
    return cycles / e0.elapsed_time(e1)


def time_ms(fn, reps: int, warmup: int = 2):
    """(device ms, host ms) per call over ``reps`` calls after warm-up.

    The device time is the kernels' own: the calls are enqueued behind a
    ``torch.cuda._sleep`` that outlasts their enqueue, so the two CUDA
    events around them bracket back-to-back device work and no host time.
    The host time is the host clock over the same enqueue: what the
    wrapper costs the caller per call. If the sleep ended before the host
    had enqueued every call, the sleep is made longer and the run repeated;
    it fails if that never holds: when a call waits on the device, or when
    ``reps`` calls queue more launches than the card's launch queue holds
    (about a thousand: then the host blocks until the device drains it),
    so a call of many launches is timed over few ``reps``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    rate = _sleep_cycles_per_ms()
    sleep_ms = 5.0
    for _ in range(3):
        es, t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        h0 = time.perf_counter()
        es.record()
        torch.cuda._sleep(int(sleep_ms * rate))
        t0.record()
        h1 = time.perf_counter()
        for _ in range(reps):
            fn()
        h2 = time.perf_counter()
        t1.record()
        t1.synchronize()
        slept = es.elapsed_time(t0)
        if (h2 - h0) * 1e3 < slept:
            return t0.elapsed_time(t1) / reps, (h2 - h1) * 1e3 / reps
        sleep_ms = 2.0 * (h2 - h0) * 1e3 + 5.0
    fail(f"time_ms: the host's enqueue of {reps} calls outlasted every "
         f"sleep (last {slept:.1f} ms): the device time would hold host "
         f"time")


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """ms per call of a plain twin: CUDA events around ``reps`` calls after
    warm-up. A twin is a long chain of launches, some of which wait on the
    host, so its time is what the caller waits, host time included."""
    import torch
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


def touched_atlas_elements(pyrs, H, pt, lod, cam_mask, keep, radius, lo,
                           hi_margin, rows=2048):
    """The distinct atlas elements the bilinear taps of a warp must read:
    only samples inside the margins, of visible cameras, of kept rows.
    H [N, C, 3, 3], pt [N, 2], lod [N], cam_mask [N, C], keep [N] bool.
    Returns a bool map over the flattened atlas (what the kernel must move
    from memory, whatever its padding and whatever the LOD bands hold)."""
    import torch
    from pais_mvs_tpu_torch.ops import fitness as F
    C, Ha, Wa = pyrs.images.shape
    touched = torch.zeros(C * Ha * Wa, dtype=torch.bool, device=pt.device)
    offs = torch.as_tensor(F.window_offsets(radius), device=pt.device)
    cam = torch.arange(C, device=pt.device)
    for s in range(0, pt.shape[0], rows):
        sl = slice(s, s + rows)
        win = pt[sl, None, :] + offs                          # [n, W2, 2]
        x, y = win[..., 0][..., None], win[..., 1][..., None]
        Hc = H[sl, None]                                      # [n,1,C,3,3]
        w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
        sw = torch.where(w == 0, 1.0, w)
        u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
        v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
        dims = pyrs.dims[cam, lod[sl, None].long()].float()   # [n, C, 2]
        hgt, wid = dims[:, None, :, 0], dims[:, None, :, 1]
        ok = ((u >= lo) & (u < wid - hi_margin) & (v >= lo)
              & (v < hgt - hi_margin) & (w != 0)
              & cam_mask[sl, None, :] & keep[sl, None, None])
        yo = pyrs.yoff[lod[sl].long()][:, None, None]
        # the kernels' clamps; the margins keep every kept tap in its band
        x0 = torch.floor(u).clamp(0, Wa - 2).long()
        y0 = (torch.floor(v).long() + yo).clamp(0, Ha - 2)
        i00 = (cam * (Ha * Wa) + y0 * Wa + x0)[ok]
        for d in (0, 1, Wa, Wa + 1):
            touched[i00 + d] = True
    return touched


def k1_bound_ms(scene, cfg, H, pt, ref, cam_mask, lod, pvalid, active):
    """K1's roofline bound on these inputs: (ms, "bytes" or "operations",
    a description). Operations: the FP32 work of the kept particles
    (valid and in an active swarm). Bytes: the atlas elements their taps
    read (bilinear taps inside K1's margins, plus the nearest reference
    pixel of every window pixel in images and, with the gradient weight,
    in edges), H and pt of the kept particles, the small inputs whole, the
    output."""
    import torch
    from pais_mvs_tpu_torch.ops import fitness as F
    B, P, C = H.shape[:3]
    r = cfg.patch_radius
    W2 = (2 * r + 1) ** 2
    keep = pvalid & active[:, None]
    live = keep.sum(1)                                        # [B]
    ncam = cam_mask.sum(1)
    ops = float((live * W2 * (ncam * K1_OPS_SAMPLE + K1_OPS_PIXEL
                              + (K1_OPS_GRAD if cfg.adaptive_gradient_enable
                                 else 0))).sum())
    atlas = scene.pyramids.images
    kept = keep.reshape(-1)
    img_t = touched_atlas_elements(
        scene.pyramids, H.reshape(B * P, C, 3, 3), pt.reshape(B * P, 2),
        lod.repeat_interleave(P), cam_mask.repeat_interleave(P, 0), kept, r,
        2.0, 3.0)
    offs = torch.as_tensor(F.window_offsets(r), device=pt.device)
    win = pt.reshape(B * P, 1, 2)[kept] + offs                 # [n, W2, 2]
    Ha, Wa = atlas.shape[1:]
    lk = lod.repeat_interleave(P)[kept].long()[:, None]
    xi = torch.round(win[..., 0]).to(torch.int32).clamp(0, Wa - 1).long()
    yi = (torch.round(win[..., 1]).to(torch.int32).long()
          + scene.pyramids.yoff[lk]).clamp(0, Ha - 1)
    ridx = (ref.repeat_interleave(P)[kept].long()[:, None] * (Ha * Wa)
            + yi * Wa + xi).reshape(-1)
    ref_t = torch.zeros_like(img_t)
    ref_t[ridx] = True
    n_img = int((img_t | ref_t).sum())
    n_edge = int(ref_t.sum()) if cfg.adaptive_gradient_enable else 0
    n_kept = int(kept.sum())
    nbytes = float((n_img + n_edge) * atlas.element_size()
                   + n_kept * (C * 9 + 2) * 4 + pvalid.numel()
                   + ref.numel() * 4 + lod.numel() * 4 + cam_mask.numel()
                   + active.numel() + W2 * 4 + B * P * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            f"{ops:.3e} FP32 ops, {nbytes:.3e} bytes of which atlas {n_img} "
            f"image + {n_edge} edge elements of {atlas.numel()}, {n_kept} "
            f"of {B * P} particles kept")


def first_evaluation(scene, cfg, pb, P, gen):
    """The inputs of a seed round's first PSO evaluation: (ref_cam, lod,
    ray, active, pos [B, P, 3]) with P particles drawn uniformly in the
    PSO bounds (lifecycle.refine_batch's seed-mode lo/hi), every live
    swarm active."""
    import torch
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    B, dev = pb.capacity, pb.device
    ref = lc.set_reference_camera(scene, pb.normal(), pb.cam_mask)
    depth, ray = lc.set_depth_and_ray(scene, pb.center, ref)
    dr, drop = lc.set_depth_range(scene, cfg, pb.center, ray, depth, ref,
                                  pb.cam_mask,
                                  torch.tensor(0.005, device=dev))
    lod = lc.set_lod(scene, cfg, pb.center, ref)
    lo = torch.stack([torch.zeros(B, device=dev),
                      pb.normal_sph[:, 1] - np.pi / 2, dr[:, 0]], -1)
    hi = torch.stack([torch.full((B,), np.pi, device=dev),
                      pb.normal_sph[:, 1] + np.pi / 2, dr[:, 1]], -1)
    u = torch.rand((B, P, 3), generator=gen, device=dev)
    return (ref, lod, ray, pb.valid & ~drop,
            lo[:, None] + (hi - lo)[:, None] * u)


def selftest_inputs(scene, cfg, pb, n, P, seed):
    """bench.py:135-145: n patches x P particles around their prepared
    state with deliberately wide noise (0.3, 0.3 rad; 0.002 depth)."""
    import torch
    from pais_mvs_tpu_torch.models import patch as pm
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    sub = pm.take(pb, np.arange(min(n, pb.capacity)))
    ref = lc.set_reference_camera(scene, sub.normal(), sub.cam_mask)
    depth, ray = lc.set_depth_and_ray(scene, sub.center, ref)
    lod = lc.set_lod(scene, cfg, sub.center, ref)
    noise = np.random.default_rng(seed).normal(size=(sub.capacity, P, 3)) \
        * np.array([0.3, 0.3, 0.002])
    pos = torch.stack([sub.normal_sph[:, 0], sub.normal_sph[:, 1], depth],
                      -1)[:, None, :] + torch.tensor(
                          noise, dtype=torch.float32, device=depth.device)
    return sub, ref, lod, ray, pos


def check_fitness(label, scene, cfg, ref, mask, lod, ray, pos, active=None,
                  no_valid=False):
    """K1 vs its plain twin on the same inputs (``no_valid``: every
    particle marked invalid); returns max |err|."""
    import torch
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import fitness as F
    H, pt, pvalid = F.fitness_geometry(scene, cfg, ref, mask, lod, ray, pos)
    if no_valid:
        pvalid = torch.zeros_like(pvalid)
    args = (scene.pyramids, cfg, H, pt, ref, mask, lod, pvalid, active)
    plain = F.score_windows(*args)
    kern = CF.score_windows(*args)
    torch.cuda.synchronize()
    if active is not None:
        plain = torch.where(active[:, None], plain, 1e30)
    big_p, big_k = plain >= 1e20, kern >= 1e20
    if not torch.equal(big_p, big_k):
        fail(f"K1 {label}: BIG sets differ in {int((big_p != big_k).sum())} "
             f"of {big_p.numel()} candidates")
    ok = ~big_p
    err = (kern - plain).abs()[ok]
    lim = 1e-4 * torch.clamp(plain.abs()[ok], min=1.0)
    if not bool(torch.isfinite(kern[ok]).all()) or bool((err > lim).any()):
        fail(f"K1 {label}: max |err| {float(err.max()):.3g} over tolerance")
    m = float(err.max()) if err.numel() else 0.0
    log(f"K1 {label}: {int(ok.sum())}/{ok.numel()} scored, BIG set equal, "
        f"max |err| {m:.3g}")
    return m, (H, pt, pvalid)


def check_sampler(label, scene, cfg, center, normal, ref, mask, lod):
    """K2 vs its plain twin on the same inputs; returns (max |err|, (H,
    pt))."""
    from pais_mvs_tpu_torch.ops import fitness as F
    H, _, pt = F.warp_geometry(scene, cfg, center, normal, ref, lod)
    return compare_sampler(label, (scene.pyramids, H, pt, lod, mask,
                                   cfg.patch_radius)), (H, pt)


def compare_sampler(label, args):
    """K2 on ``args`` (``warped_samples``' arguments) against its plain
    twin: the same valid samples, |err| <= 1e-5 (relative above 1);
    returns max |err|."""
    import torch
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import fitness as F
    plain = F.warped_samples(*args)
    kern = CF.warped_samples(*args)
    torch.cuda.synchronize()
    okp, okk = plain > F.INVALID / 2, kern > F.INVALID / 2
    if not torch.equal(okp, okk):
        fail(f"K2 {label}: ok sets differ in {int((okp != okk).sum())} "
             f"samples")
    err = (kern - plain).abs()[okp]
    m = float(err.max()) if err.numel() else 0.0
    if m > 0 and m > 1e-5 * max(1.0, float(plain[okp].abs().max())):
        fail(f"K2 {label}: max |err| {m:.3g} over tolerance")
    log(f"K2 {label}: {int(okp.sum())}/{okp.numel()} samples valid, ok set "
        f"equal, max |err| {m:.3g}")
    return m


def view_inputs(scene, cfg, ref, mask, lod, ray, pos, c, active=None,
                own_every=3, no_valid=False):
    """The view kernels' inputs on the camera block of size ``c`` holding
    the rig's middle camera: the block's pyramids, H to its cameras,
    window centres, act (visible x ``active``), the block's cam_mask,
    pvalid (all False with ``no_valid``), the reference camera's local
    index, own (off on every ``own_every``-th patch, as if another rank
    held it), and last each patch's number of visible cameras in the
    whole rig (the global mean's divisor)."""
    import torch
    from pais_mvs_tpu_torch.ops import fitness as F
    from pais_mvs_tpu_torch.ops import view_fitness as VF
    C = scene.num_cameras
    H, pt, pvalid = F.fitness_geometry(scene, cfg, ref, mask, lod, ray, pos)
    vi = (C // 2) // c
    off = vi * c
    pyrs = VF._local_pyramids(scene.view_block(vi, C // c).pyramids, off, c)
    mloc = mask[:, off:off + c].contiguous()
    act = mloc if active is None else (active[:, None] & mloc).contiguous()
    own, ref_loc = VF.own_and_local(ref, off, c)
    own = own & (torch.arange(ref.shape[0], device=ref.device)
                 % own_every != 0)
    if no_valid:
        pvalid = torch.zeros_like(pvalid)
    return (pyrs, H[:, :, off:off + c].contiguous(), pt, lod, act, mloc,
            pvalid, ref_loc, own, mask.sum(-1).float())


def check_view_kernels(label, args, radius, edges):
    """The view fitness's kernels against their plain twins on the same
    inputs (``compare_view_kernels``), B against the plain mean over the
    rig's visible cameras (``args``' last entry; as one view rank sees
    it). Returns (max |err| of A, of B)."""
    from pais_mvs_tpu_torch.ops import fitness as F
    pyrs, H, pt, lod, act, mask, pvalid, ref_loc, own, cn = args
    am = (pyrs, H, pt, lod, act, mask, pvalid, ref_loc, own, radius, edges)
    mean = F.view_moments(*am)[0] / cn.clamp(min=1)[:, None, None]
    return compare_view_kernels(label, am, (pyrs, H, pt, lod, act, pvalid,
                                            mean, radius))


def compare_view_kernels(label, am, ad):
    """A (view_moments) on ``am`` and B (view_deviation) on ``ad``, their
    argument tuples, against their plain twins: A's planes 1-3 equal on
    rows with a finite window centre (the others are never read: their
    particles are invalid), plane 0 to 1e-5 (relative above 1); B to
    1e-5. Returns (max |err| of A, of B)."""
    import torch
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import fitness as F
    pt, pvalid = am[2], am[6]
    plain = F.view_moments(*am)
    kern = CF.view_moments(*am)
    dplain = F.view_deviation(*ad)
    dkern = CF.view_deviation(*ad)
    torch.cuda.synchronize()
    rows = torch.isfinite(pt).all(-1)
    if not torch.equal(kern[1:][:, rows], plain[1:][:, rows]):
        fail(f"view_moments {label}: planes 1-3 differ in "
             f"{int((kern[1:][:, rows] != plain[1:][:, rows]).sum())} "
             f"values")
    errs = []
    for name, k, p in (("view_moments plane 0", kern[0], plain[0]),
                       ("view_deviation", dkern, dplain)):
        err = (k - p).abs()
        m = float(err.max()) if err.numel() else 0.0
        if not bool(torch.isfinite(k).all()) or bool(
                (err > 1e-5 * torch.clamp(p.abs(), min=1.0)).any()):
            fail(f"{name} {label}: max |err| {m:.3g} over tolerance")
        errs.append(m)
    log(f"view kernels {label}: {int(pvalid.sum())}/{pvalid.numel()} valid "
        f"particles, {int((plain[1] > 0).sum())} pixels with an invalid "
        f"camera, {int((plain[2] != 0).sum())} reference pixels; planes "
        f"1-3 equal, max |err| plane 0 {errs[0]:.3g}, deviation "
        f"{errs[1]:.3g}")
    return tuple(errs)


def ref_pixels(pyrs, pt, ref_cam, own, lod, radius) -> int:
    """The distinct atlas pixels the reference lookups of the owned rows
    read (round(pt + offset), clamped as the kernels clamp)."""
    import torch
    from pais_mvs_tpu_torch.ops import fitness as F
    _, Ha, Wa = pyrs.images.shape
    win = pt[own][:, :, None, :] + torch.as_tensor(
        F.window_offsets(radius), device=pt.device)           # [n,P,W2,2]
    yo = pyrs.yoff[lod[own].long()][:, None, None]
    xr = torch.round(win[..., 0]).to(torch.int32).clamp(0, Wa - 1).long()
    yr = (torch.round(win[..., 1]).to(torch.int32) + yo).clamp(
        0, Ha - 1).long()
    return int(torch.unique(ref_cam[own].long()[:, None, None] * (Ha * Wa)
                            + yr * Wa + xr).numel())


def view_bound_ms(args, radius, edges, n_ref):
    """A's and B's roofline bounds on these inputs: ((ms, "bytes" or
    "operations", description) of A, the same of B). Operations: the FP32
    work of the samples each computes (active camera x valid particle x
    window pixel) and of each window pixel. Bytes: the atlas elements the
    samples' taps read (inside the margins), the distinct reference
    pixels A reads (``n_ref``, in each of its reference planes), H of
    the cameras each sampled and the window centres, the small inputs
    whole, B's mean where it samples, each output written once."""
    pyrs, H, pt, lod, act, mask, pvalid = args[:7]
    B, P, C = H.shape[:3]
    W2 = (2 * radius + 1) ** 2
    pairs = act[:, None, :] & pvalid[:, :, None]               # [B, P, c]
    n_pairs = int(pairs.sum())
    live = int(pairs.any(-1).sum())
    n_taps = int(touched_atlas_elements(
        pyrs, H.reshape(B * P, C, 3, 3), pt.reshape(B * P, 2),
        lod.repeat_interleave(P), act.repeat_interleave(P, 0),
        pvalid.reshape(-1), radius, 2.0, 3.0).sum())
    esz = pyrs.images.element_size()
    small = B * 4 + act.numel() + pvalid.numel()       # lod, act, pvalid
    planes = 4 if edges else 3
    a_bytes = float((n_taps + (planes - 2) * n_ref) * esz
                    + n_pairs * 9 * 4 + B * P * 2 * 4 + small
                    + mask.numel() + B * 5 + planes * B * P * W2 * 4)
    a_ops = float(n_pairs * W2 * VIEW_A_OPS_SAMPLE
                  + B * P * W2 * REF_OPS_PIXEL)
    b_bytes = float(n_taps * esz + n_pairs * 9 * 4 + B * P * 2 * 4 + small
                    + live * W2 * 4 + B * P * W2 * 4)
    b_ops = float(n_pairs * W2 * VIEW_B_OPS_SAMPLE + live * W2 * 2)
    out = []
    for nb, no in ((a_bytes, a_ops), (b_bytes, b_ops)):
        tb, to = nb / HBM_BYTES_PER_S, no / FP32_OPS_PER_S
        out.append((max(tb, to) * 1e3, "bytes" if tb >= to else "operations",
                    f"{no:.3e} FP32 ops, {nb:.3e} bytes of which atlas "
                    f"{n_taps} tap elements, {n_pairs} (camera, particle) "
                    f"pairs sampled"))
    return tuple(out)


def check_view_fitness(label, scene, cfg, ref, mask, lod, ray, pos, view):
    """The view-sharded fitness (the two view kernels around the psums) vs
    flat K1; returns max |err|."""
    import torch
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import view_fitness as VF
    flat = CF.patch_fitness(scene, cfg, ref, mask, lod, ray, pos)
    got = VF.fitness_view(scene.view_block(view.index, view.size), cfg, ref,
                          mask, lod, ray, pos, view)
    return compare_fitness(f"view fitness {label}", got, flat)


def compare_fitness(label, got, want):
    """Exact BIG set, |err| <= 1e-4 (relative above 1); returns max
    |err|."""
    import torch
    torch.cuda.synchronize()
    big_w, big_g = want >= 1e20, got >= 1e20
    if not torch.equal(big_w, big_g):
        fail(f"{label}: BIG sets differ in {int((big_w != big_g).sum())} "
             f"of {big_w.numel()} candidates")
    ok = ~big_w
    err = (got - want).abs()[ok]
    lim = 1e-4 * torch.clamp(want.abs()[ok], min=1.0)
    if not bool(torch.isfinite(got[ok]).all()) or bool((err > lim).any()):
        fail(f"{label}: max |err| {float(err.max()):.3g} over tolerance")
    m = float(err.max()) if err.numel() else 0.0
    log(f"{label}: {int(ok.sum())}/{ok.numel()} scored, BIG set equal, "
        f"max |err| {m:.3g}")
    return m


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def timed_rounds(fn, reps: int = 3):
    """(ms per round by CUDA events, ms per round by host clock, peak
    device memory in GiB) over ``reps`` calls after the caller's warm-up."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    e0.record()
    for _ in range(reps):
        out = fn()
    e1.record()
    e1.synchronize()
    host_ms = (time.time() - t0) / reps * 1e3
    return (e0.elapsed_time(e1) / reps, host_ms,
            torch.cuda.max_memory_allocated() / 2 ** 30, out)


# phase 16's configuration: tools/dist_realistic_2k.py:44-47 (batchSize and
# wavefrontSize stay at the engine's defaults, 1024 and 4096)
REAL_CONFIG_TXT = ("patchRadius 6\nmaxLOD 6\nparticleNum 8\nmaxIteration 12\n"
                   "distWeighting 2.0\ncellSize 12\nminCamNum 3\n"
                   "maxCellPatchNum 2\nneighborRadiusScalar 0.01\n"
                   "seedRefineRounds 2\n")
R_ARTIFACTS = ("init.mvs", "seed.mvs", "exp.mvs", "auto_save.mvs",
               "auto_save.mvs.state.npz", "exp.ply", "exp.psr", "stats.json",
               "log.txt")
F_ARTIFACTS = tuple(f"{stem}.{ext}" for stem in (
    "PMVS_filter1", "PMVS_filter2", "PMVS_filter3", "PMVS_filter_deleted",
    "PCMVS_filter", "PCMVS_filter_deleted") for ext in ("mvs", "ply"))


def write_scene_files(out_dir, scene, config_txt):
    """The scene as a user hands it to the CLI: PNG images, an NVM (image
    points centre-origin) and a config.txt. Returns the NVM's path."""
    import dataclasses
    from PIL import Image
    from pais_mvs_tpu_torch.io.nvm import save_nvm
    params = [dataclasses.replace(p, file_name=os.path.splitext(
        p.file_name)[0] + ".png") for p in scene.params]
    for p, img in zip(params, scene.images):
        Image.fromarray(img).save(os.path.join(out_dir, p.file_name))
    ipts = scene.seed_img_points.copy()
    for c, img in enumerate(scene.images):
        ipts[:, c, 0] -= img.shape[1] // 2
        ipts[:, c, 1] -= img.shape[0] // 2
    path = os.path.join(out_dir, "scene.nvm")
    save_nvm(path, params, scene.seed_centers,
             np.full((len(scene.seed_centers), 3), 128.0),
             scene.seed_cam_masks, ipts)
    with open(os.path.join(out_dir, "config.txt"), "w") as f:
        f.write(config_txt)
    return path


def run_cli(argv, cwd):
    """``cli.main(argv)`` in this process with ``cwd`` as the working
    directory (config.txt resolves from it); returns (exit code, stdout
    lines of the run)."""
    import contextlib
    import io
    from pais_mvs_tpu_torch import cli
    here, buf = os.getcwd(), io.StringIO()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        os.chdir(here)
    return rc, buf.getvalue().splitlines()


def removal_counts(lines):
    """``{what: count}`` of the engine's "<what> removed N" log lines."""
    out = {}
    for line in lines:
        if " removed " in line:
            what, rest = line.split(" removed ", 1)
            out[what] = int(rest.split()[0])
    return out


def cli_reconstructor(nvm, work, dev):
    """The Reconstructor the CLI builds from its files (``work`` holds
    config.txt), holding the files' seeds, not yet refined, and logging
    into ``work``/profiled."""
    from pais_mvs_tpu_torch import cli
    prof_dir = os.path.join(work, "profiled")
    os.makedirs(prof_dir)
    here = os.getcwd()
    os.chdir(work)
    try:
        return cli._build_reconstructor(nvm, prof_dir, dev)
    finally:
        os.chdir(here)


def check_r_shapes(rec, seeds, gen, label="-r shape"):
    """K1 and K2 against their plain twins at ``-r``'s shapes: ``rec``'s
    scene and configuration (the engine's own, built from the CLI's files
    as the CLI builds them) and ``seeds`` (centres, camera masks, pixel
    image points of a render of the same scene) prepared on that scene,
    at the expansion's P and the seed rounds' 2P; then once more with each
    row's LOD cycled through every band of the atlas (capped at its
    reference camera's maxLOD). Returns K1's and K2's max |err|."""
    import torch
    from pais_mvs_tpu_torch.models import patch as pm
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    dev = gen.device
    rs, rc = rec.scene, rec.cfg
    pb = lc.prepare_seeds(rs, rc, pm.from_seeds(*seeds, device=dev))
    n_rows = pb.capacity
    L = rs.pyramids.num_levels
    every_band = lambda ref: torch.minimum(torch.arange(
        n_rows, device=dev, dtype=torch.int32) % L, rs.rig.max_lod[ref])
    err1 = err2 = 0.0
    for P in (rc.particle_num, 2 * rc.particle_num):
        sub, ref, lod, ray, pos = selftest_inputs(rs, rc, pb, n_rows, P, P)
        err1 = max(err1, check_fitness(
            f"{label} (B={n_rows}, r={rc.patch_radius}) P={P} around the "
            f"prepared seeds", rs, rc, ref, sub.cam_mask, lod, ray, pos)[0])
        err1 = max(err1, check_fitness(
            f"{label} P={P} every band", rs, rc, ref, sub.cam_mask,
            every_band(ref), ray, pos)[0])
        ref, lod, ray, act, pos = first_evaluation(rs, rc, pb, P, gen)
        err1 = max(err1, check_fitness(
            f"{label} P={P} first seed-round evaluation", rs, rc, ref,
            pb.cam_mask, lod, ray, pos, act)[0])
    n = pb.normal()
    ref = lc.set_reference_camera(rs, n, pb.cam_mask)
    lod = lc.set_lod(rs, rc, pb.center, ref)
    for shift in (0.0, 0.002):
        for what, lv in (("", lod), (" every band", every_band(ref))):
            err2 = max(err2, check_sampler(
                f"{label} (B={n_rows}, r={rc.patch_radius}) shift={shift}"
                f"{what}", rs, rc, pb.center + shift, n, ref, pb.cam_mask,
                lv)[0])
    log(f"{label}: atlas {tuple(rs.pyramids.images.shape)}, maxLOD "
        f"{rc.max_lod}, the prepared seeds' LOD levels "
        f"{np.bincount(lod.cpu().numpy(), minlength=L)}; K1 max |err| "
        f"{err1:.3g}, K2 {err2:.3g}")
    return err1, err2


def device_busy_s(prof):
    """(seconds the device was busy, number of device activities) in a
    ``torch.profiler`` run: the union of its kernel, copy and set
    intervals."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        fail("the profiler recorded no device activity")
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + cur_e - cur_s) / 1e6, len(spans)


# phase 18's yardstick: the JAX package's feature seeding on this scene
# (generate_seed_patches on the CPU, MvsConfig(min_cam_num=3), epipolar
# tolerance 3.0 px): 363 seeds at median surface distance 4.33e-4
JAX_FEATURE_SEEDS, JAX_FEATURE_MEDIAN = 363, 4.33e-4
# phase 20's bar for warped_windows, card against CPU, in 0..255 intensity
# levels: the two devices compose the homographies with sums in another
# order, so the samples land ~1e-4 px apart at 1280x960, and the photo's
# gradients (up to ~250 levels/px) turn that into up to a few hundredths
# of a level; 0.1 stays far under the one level the PNG mosaics resolve
WINDOW_TOL = 0.1


def feature_stage_ms(images, dev):
    """(detection + description ms, matching ms) of generate_seed_patches'
    device stages on ``images``, host clock around synchronised calls."""
    import torch
    from pais_mvs_tpu_torch.features import matching as mat
    from pais_mvs_tpu_torch.features.seeding import detect_and_describe
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kds = [detect_and_describe(img, dev) for img in images]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    C = len(images)
    Fs = [[np.eye(3)] * C for _ in range(C)]
    mat.match_all_pairs([d for _, d in kds], [k.xy for k, _ in kds],
                        [k.mask for k, _ in kds], Fs)
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def ba_problem(scene_files, seed=0):
    """The rig's bundle-adjustment problem over its seed tracks, with
    cameras 1.. perturbed from a numpy seed (rotation N(0, 0.005) rad per
    axis, centre N(0, 0.01)); returns (float32 fields, true R, true
    centres)."""
    import torch
    from pais_mvs_tpu_torch.models.camera import _np_quat_to_rotation
    from pais_mvs_tpu_torch.ops.bundle import _exp_so3
    ps, ims = scene_files.params, scene_files.images
    R = np.stack([_np_quat_to_rotation(np.asarray(p.quaternion, float))
                  for p in ps])
    cen = np.stack([np.asarray(p.center, float) for p in ps])
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.005, (len(ps), 3))
    w[0] = 0
    dc = rng.normal(0, 0.01, (len(ps), 3))
    dc[0] = 0
    fields = [_exp_so3(torch.tensor(w)).numpy() @ R, cen + dc,
              np.stack([np.asarray(p.focal, float) for p in ps]),
              np.stack([[im.shape[1] >> 1, im.shape[0] >> 1] for im in ims]),
              scene_files.seed_centers, scene_files.seed_img_points,
              scene_files.seed_cam_masks]
    return ([f if f.dtype == bool else f.astype(np.float32)
             for f in fields], R, cen)


def scale_aligned(c, ref):
    """Centres ``c`` scaled about camera 0 onto ``ref``'s scale (the gauge
    bundle adjustment leaves free)."""
    s = np.linalg.norm(ref[1] - ref[0]) / np.linalg.norm(c[1] - c[0])
    return (c - c[0]) * s + ref[0]


# phase 24's depth: rounds of the view-sharded expansion
DIST_VP_ROUNDS = 3


def cloud_agreement(a, b, tol):
    """(share of ``a`` within ``tol`` of a point of ``b``, and of ``b``
    within ``tol`` of ``a``): pais_mvs_tpu/oracle.py::cloud_agreement's
    mutual agreement, by nearest neighbour in a k-d tree."""
    from scipy.spatial import cKDTree
    if len(a) == 0 or len(b) == 0:
        return 0.0, 0.0
    return (float((cKDTree(b).query(a)[0] <= tol).mean()),
            float((cKDTree(a).query(b)[0] <= tol).mean()))


def half_cell(scene_files, cell_size):
    """Half a cell's world footprint at the scene's depth (the parity
    tests' tolerance)."""
    cams = np.array([p.center for p in scene_files.params], float)
    depth = float(np.linalg.norm(scene_files.seed_centers.mean(0)
                                 - cams.mean(0)))
    return 0.5 * cell_size * depth / float(scene_files.params[0].focal[0])


def r_gates(label, out_dir, scene_files, n_seeds):
    """Phase 16's gates on an ``-r`` output directory: every artifact,
    accepted seeds > 40%, the cloud >= 20x the accepted seeds, median
    surface distance < 2.5e-3, exp.mvs holding stats.json's live count.
    Returns (stats, the cloud's centres, its median)."""
    from pais_mvs_tpu_torch.io import mvsbin
    missing = [a for a in R_ARTIFACTS
               if not os.path.exists(os.path.join(out_dir, a))]
    if missing:
        fail(f"{label}: artifacts missing {missing}")
    with open(os.path.join(out_dir, "stats.json")) as f:
        st = json.load(f)
    c = mvsbin.read_mvs(os.path.join(out_dir, "exp.mvs")).patches.centers
    med = float(np.median(scene_files.surface_distance(c)))
    n_acc = st["seed_accepted"]
    if not n_acc > 0.4 * n_seeds:
        fail(f"{label}: {n_acc}/{n_seeds} seeds accepted (gate > 40%)")
    if not len(c) >= 20 * n_acc:
        fail(f"{label}: the cloud grew to {len(c)} from {n_acc} seeds "
             f"(gate: 20x)")
    if not med < 2.5e-3:
        fail(f"{label}: median surface distance {med:.6f} (gate < 2.5e-3)")
    if st["live_patches"] != len(c) or not np.isfinite(c).all():
        fail(f"{label}: exp.mvs holds {len(c)} patches, stats.json "
             f"{st['live_patches']} live (or non-finite centres)")
    return st, c, med


def agreement_gates(label, c, ref, tol):
    """The realistic-parity bars against a yardstick cloud: mutual
    agreement >= 0.65 each way, count ratio in [0.7, 1.43]."""
    ag = cloud_agreement(c, ref, tol)
    ratio = len(c) / max(len(ref), 1)
    if min(ag) < 0.65 or not 0.7 <= ratio <= 1.43:
        fail(f"{label}: agreement {ag[0]:.3f} / {ag[1]:.3f} (gate >= 0.65), "
             f"count ratio {ratio:.3f} (gate [0.7, 1.43])")
    return ag, ratio


class StepRecorder:
    """While installed (``with``), records each round's accepted mask and
    refined centres of ``parallel.expansion.expand_step``, as this run's
    ``expand_distributed`` calls it."""

    def __enter__(self):
        from pais_mvs_tpu_torch.parallel import expansion
        self.rounds = []
        self._mod, self._step = expansion, expansion.expand_step

        def step(*a, **k):
            out = self._step(*a, **k)
            self.rounds.append((out[1].cpu().numpy(),
                                out[0].center.cpu().numpy()))
            return out
        expansion.expand_step = step
        return self

    def __exit__(self, *exc):
        self._mod.expand_step = self._step


class FirstCalls:
    """While installed (``with``), passes every call of the named
    ``cuda_fitness`` wrappers through and keeps a copy of the arguments of
    each one's first call (``self.args[name]``), as the code that calls
    them passed them."""

    def __init__(self, *names):
        self.names = names

    def __enter__(self):
        import torch
        from pais_mvs_tpu_torch.ops import cuda_fitness as CF
        self.args, self._orig = {}, {n: getattr(CF, n) for n in self.names}
        own = lambda a: a.clone() if isinstance(a, torch.Tensor) else a

        def wrap(name, fn):
            def call(*a):
                if name not in self.args:
                    self.args[name] = tuple(map(own, a))
                return fn(*a)
            return call
        for n, fn in self._orig.items():
            setattr(CF, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        from pais_mvs_tpu_torch.ops import cuda_fitness as CF
        for n, fn in self._orig.items():
            setattr(CF, n, fn)


def dist_stage(nvm, work, out_dir, dev, mesh_shape=None, first=()):
    """Phase 24's run on one rank: the CLI's Reconstructor on phase 16's
    files (config.txt from ``work``), the seed stage, then
    ``DIST_VP_ROUNDS`` rounds of ``expand_distributed`` with the launches
    counted, each round recorded and the first call's arguments of each
    wrapper named in ``first`` kept. Returns (Reconstructor, seed
    centres, launches, the rounds, seconds of the expansion, the first
    calls' arguments by name)."""
    import torch
    from pais_mvs_tpu_torch import cli
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    here = os.getcwd()
    os.chdir(work)
    try:
        rec = cli._build_reconstructor(nvm, out_dir, dev,
                                       mesh_shape=mesh_shape)
    finally:
        os.chdir(here)
    rec.logger.echo = False
    rec.refine_seeds()
    seeds = rec.arena.data["center"][:rec.arena.count].copy()
    torch.cuda.synchronize()
    CF.reset_launch_counts()
    t0 = time.time()
    with StepRecorder() as steps, FirstCalls(*first) as calls:
        rec.expand_distributed(max_rounds=DIST_VP_ROUNDS)
    torch.cuda.synchronize()
    return (rec, seeds, dict(CF.LAUNCHES), steps.rounds, time.time() - t0,
            calls.args)


def dist_worker(rank, world, port, out_dir):
    """One rank of phase 24 (``chip_smoke.py --dist-rank RANK WORLD PORT
    DIR``): gloo over localhost, all ranks on card 0, the (1, WORLD) mesh;
    reads DIR/payload.pkl and writes DIR/rank<RANK>.npz. Rank 0 also
    holds A, B and K2 against their plain twins on the arguments of their
    first call inside the expansion (the first view evaluation of round
    0 and its NCC vectors: the scale-2 atlas's one-camera block, the
    expansion's P and the round's refine rows) and writes the errors
    (``errs``: A, B, K2)."""
    sys.path.insert(0, HERE)
    import torch
    from pais_mvs_tpu_torch.parallel.distributed import init_distributed
    with open(os.path.join(out_dir, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    dev = init_distributed(f"tcp://localhost:{port}", rank, world,
                           backend="gloo", device="cuda", timeout_s=300)
    names = ("view_moments", "view_deviation", "warped_samples")
    rec, seeds, launches, rounds, wall, first = dist_stage(
        payload["nvm"], payload["work"],
        os.path.join(out_dir, f"rank{rank}"), dev, mesh_shape=(1, world),
        first=names if rank == 0 else ())
    extra = {}
    if rank == 0:
        if sorted(first) != sorted(names):
            fail(f"vp={world}: the expansion called only {sorted(first)} "
                 f"of {names}")
        am = first["view_moments"]
        label = (f"vp={world} expansion's first call (B={am[1].shape[0]}, "
                 f"P={am[1].shape[1]}, c={am[1].shape[2]}, atlas "
                 f"{tuple(am[0].images.shape)})")
        ea, eb = compare_view_kernels(label, am, first["view_deviation"])
        e2 = compare_sampler(label, first["warped_samples"])
        extra["errs"] = np.array([ea, eb, e2])
    a = rec.arena
    n = a.count
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), seeds=seeds, **extra,
             alive=a.alive[:n], expanded=a.expanded[:n],
             launches=np.array([launches[k] for k in sorted(launches)]),
             acc0=rounds[0][0], center0=rounds[0][1], wall=np.array(wall),
             rounds=np.array(len(rounds)),
             **{f"d_{k}": v[:n] for k, v in a.data.items()})
    torch.distributed.destroy_process_group()


def vp_worker(rank, world, port, out_dir):
    """One rank of phase 12 (``chip_smoke.py --vp-rank RANK WORLD PORT
    DIR``): gloo over localhost, all ranks on card 0; reads its inputs from
    DIR/payload.pkl and writes DIR/rank<RANK>.npz."""
    sys.path.insert(0, HERE)
    import torch
    from pais_mvs_tpu_torch.models.camera import build_scene
    from pais_mvs_tpu_torch.models.patch import PatchBatch
    from pais_mvs_tpu_torch.ops import view_fitness as VF
    from pais_mvs_tpu_torch.ops.pso import PsoDraws
    from pais_mvs_tpu_torch.parallel.distributed import init_distributed
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    from pais_mvs_tpu_torch.parallel.sharded import refine_sharded
    with open(os.path.join(out_dir, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    dev = init_distributed(f"tcp://localhost:{port}", rank, world,
                           backend="gloo", device="cuda", timeout_s=300)
    mesh = make_mesh((1, world))
    view = mesh.view
    cfg = payload["cfg"]
    blk = build_scene(payload["params"], payload["images"], cfg, device=dev,
                      view_block=(view.index, view.size))
    on = lambda a: torch.as_tensor(a, device=dev)
    fit = VF.fitness_view(blk, cfg, *map(on, payload["fit_in"]), view)
    pb = PatchBatch(**{k: on(v) for k, v in payload["pb"].items()})
    draws = [PsoDraws(*map(on, payload["draws"]))]
    res = refine_sharded(blk, cfg, pb, 0.005, True, 1, mesh.patch, view,
                         draws=draws)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             fit=fit.cpu().numpy(), valid=res.batch.valid.cpu().numpy(),
             center=res.batch.center.cpu().numpy(),
             images=np.asarray(blk.pyramids.images.shape))
    torch.distributed.destroy_process_group()


def start_children(argvs, cwd=None, env=None, logs=None) -> list:
    """Start one child process per argv, all at once (``logs``: a file per
    child that takes its stdout and stderr)."""
    procs = []
    for i, argv in enumerate(argvs):
        if logs is None:
            procs.append(subprocess.Popen(argv, cwd=cwd, env=env))
            continue
        with open(logs[i], "w") as out:
            procs.append(subprocess.Popen(argv, cwd=cwd, env=env, stdout=out,
                                          stderr=subprocess.STDOUT))
    return procs


def join_children(label, procs, deadline, logs=None):
    """Wait for ``procs`` until the ``time.time()`` ``deadline``, and kill
    and reap those still running when it passes. Fails unless every one
    exited 0, quoting the end of each ``logs`` file."""
    try:
        for p in procs:
            p.wait(max(0.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    hung = [i for i, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if hung or any(codes):
        tails = []
        for path in logs or ():
            with open(path) as f:
                tails.append(f.read()[-1500:])
        fail(f"{label}: still running {hung}, exit codes {codes}"
             + "".join(f"\n----\n{t}" for t in tails))


def run_children(label, argvs, timeout_s, cwd=None, env=None, logs=None):
    """``start_children``, then ``join_children`` with a deadline
    ``timeout_s`` from now."""
    join_children(label, start_children(argvs, cwd, env, logs),
                  time.time() + timeout_s, logs)


def run_vp_workers(world, payload, timeout_s=400.0, flag="--vp-rank"):
    """Run ``world`` ranks of ``vp_worker`` (``dist_worker`` with
    ``flag="--dist-rank"``) as child processes of this script under
    ``run_children``; returns each rank's arrays."""
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(out_dir, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        run_children(f"{flag} world of {world}", [
            [sys.executable, os.path.abspath(__file__), flag, str(r),
             str(world), str(port), out_dir] for r in range(world)],
            timeout_s)
        return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                for r in range(world)]


def differing_fields(a, b) -> list:
    """Names of the fields of two RefineResults whose bits differ."""
    import dataclasses
    import torch
    from pais_mvs_tpu_torch.models.patch import PatchBatch
    diff = [f.name for f in dataclasses.fields(PatchBatch)
            if not torch.equal(getattr(a.batch, f.name),
                               getattr(b.batch, f.name))]
    return diff + ([] if torch.equal(a.iterations, b.iterations)
                   else ["iterations"])


def event_ms(fn):
    """(ms by CUDA events around one call, ms by the host clock), after a
    synchronise: the events open when the stream reaches the call, so a
    call the host enqueues slower than the device runs is timed at the
    host's pace."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3


def median_iqr(xs):
    q1, med, q3 = np.percentile(np.asarray(xs, dtype=np.float64),
                                [25, 50, 75])
    return float(med), float(q3 - q1)


def graphs_line(lines):
    """{"captured": n, "replayed": m, "eager": k} of the last "refine
    graphs:" line of a run's log, and the logged eager reasons."""
    last = [ln for ln in lines if "refine graphs: captured" in ln]
    if not last:
        fail("the run's log has no \"refine graphs:\" line")
    words = last[-1].split("refine graphs: ", 1)[1].replace(";", ",")
    counts = {}
    for part in words.split(","):
        k, _, v = part.strip().partition(" ")
        if k in ("captured", "replayed", "eager"):
            counts[k] = int(v)
    reasons = sorted({ln.split("refine runs eagerly: ", 1)[1] for ln in lines
                      if "refine runs eagerly: " in ln})
    return counts, reasons


def alternating_pairs(label, eager, graphed, seed0=200) -> dict:
    """Ten alternating eager/graphed pairs (CUDA events and the host
    clock; median and IQR, eager/graphed per pair), then one profiled
    call of each arm (device busy time and idle share). ``eager`` and
    ``graphed`` take a seed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ms = {"eager": [], "graphed": []}
    host = {"eager": [], "graphed": []}
    for i in range(10):
        arms = (("eager", eager), ("graphed", graphed))
        for arm, fn in (arms if i % 2 == 0 else arms[::-1]):
            d, h = event_ms(lambda: fn(seed0 + i))
            ms[arm].append(d)
            host[arm].append(h)
    ratio = [e / g for e, g in zip(ms["eager"], ms["graphed"])]
    busy = {}
    for arm, fn in (("eager", eager), ("graphed", graphed)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(seed0 + 100)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        b, n_act = device_busy_s(prof)
        busy[arm] = (b * 1e3, wall * 1e3, n_act)
        del prof
    stats = {arm: median_iqr(v) for arm, v in ms.items()}
    res = dict(ms=ms, host_ms=host, ratio=median_iqr(ratio), busy=busy)
    log(f"{label}, ten alternating pairs (CUDA events): eager median "
        f"{stats['eager'][0]:.2f} ms (IQR {stats['eager'][1]:.2f}), "
        f"graphed median {stats['graphed'][0]:.2f} ms (IQR "
        f"{stats['graphed'][1]:.2f}); eager/graphed per pair median "
        f"{res['ratio'][0]:.3f} (IQR {res['ratio'][1]:.3f}); host clock "
        f"medians {median_iqr(host['eager'])[0]:.2f} / "
        f"{median_iqr(host['graphed'])[0]:.2f} ms; all eager "
        f"{[round(x, 2) for x in ms['eager']]}, all graphed "
        f"{[round(x, 2) for x in ms['graphed']]}")
    for arm, (b, wall, n_act) in busy.items():
        log(f"{label} profiled, {arm}: device busy {b:.2f} ms over "
            f"{n_act} device activities in {wall:.2f} ms, idle share "
            f"{1 - b / wall:.3f}")
    return res


def graphs_phase(scene, cfg, pb, nvm, work, exp_path, dev) -> dict:
    """Phase 25: ``ops/graphs.py``'s graphed refine against the eager one.
    (a) the flat seed round at the bench workload, (c) phase 15's
    expansion chunk and (b) the view round through an NCCL world of one
    (vp = 1): the key's first call (eager, then the capture) and two
    replays on new seeds, each bit-equal to the eager refine at its seed,
    with the launches of the eager round per call; (f) each capture's
    time, the pool's bytes and peak device memory; (e) ten alternating
    eager/graphed pairs of the flat round, the chunk and the view round
    (CUDA events; median and IQR) and one profiled call of each arm
    (device busy share); (d) ``cli.main(["-r", ...])`` on phase 16's files twice each
    way, eager (``Reconstructor(graphs=False)``) and graphed, in turns:
    every exp.mvs byte-equal to phase 16's, the same launch totals, the
    logged counts (graphed: at most one capture per key, at most 6, no
    eager refine; eager: no capture), and (g) the expansion's wall, the
    refines' launch-to-completion spans and the host's time inside
    ``_refine_all_async`` each way. Returns the numbers."""
    import torch
    from pais_mvs_tpu_torch import cli
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    from pais_mvs_tpu_torch.ops.graphs import RefineGraphs
    from pais_mvs_tpu_torch.parallel.distributed import init_distributed
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    from pais_mvs_tpu_torch.parallel.sharded import refine_sharded

    out = {}
    zero = dict.fromkeys(CF.LAUNCHES, 0)
    T = cfg.max_iteration
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    G = RefineGraphs()

    def held(label, eager, graphed, expect):
        for seed in (100, 101, 102):
            CF.reset_launch_counts()
            want = eager(seed)
            torch.cuda.synchronize()
            le = dict(CF.LAUNCHES)
            CF.reset_launch_counts()
            got = graphed(seed)
            torch.cuda.synchronize()
            lg = dict(CF.LAUNCHES)
            if le != {**zero, **expect} or lg != le:
                fail(f"graphs {label} seed {seed}: launches eager {le}, "
                     f"graphed {lg}, expected {expect}")
            diff = differing_fields(got, want)
            if diff:
                fail(f"graphs {label} seed {seed}: the graphed refine's "
                     f"bits differ from the eager refine's in {diff}")
        log(f"graphs {label}: the first call (eager, then the capture) and "
            f"two replays bit-equal to the eager refine at their seeds, "
            f"every PatchBatch field and the iterations; launches per call "
            f"{expect}")

    flat_e = lambda s: lc.refine_batch(scene, cfg, pb, 0.005, True, 1,
                                       generator=gen(s))
    flat_g = lambda s: G.refine(scene, cfg, pb, 0.005, True, 1,
                                generator=gen(s))
    held(f"(a) flat seed round (B={pb.capacity}, P={2 * cfg.particle_num}, "
         f"T={2 * T})", flat_e, flat_g,
         {"fitness": 1 + 2 * T, "sampler": 1})
    chunk_e = lambda s: lc.refine_batch(scene, cfg, pb, 0.005, False, 1,
                                        generator=gen(s))
    chunk_g = lambda s: G.refine(scene, cfg, pb, 0.005, False, 1,
                                 generator=gen(s))
    held(f"(c) expansion chunk (B={pb.capacity}, P={cfg.particle_num}, "
         f"T={T})", chunk_e, chunk_g, {"fitness": 1 + T, "sampler": 1})
    init_distributed(f"tcp://localhost:{free_port()}", 0, 1,
                     backend="nccl", device="cuda")
    mesh = make_mesh((1, 1))
    block = scene.view_block(0, 1)
    view_e = lambda s: refine_sharded(block, cfg, pb, 0.005, True, 1,
                                      mesh.patch, mesh.view, seed=s)
    view_g = lambda s: refine_sharded(block, cfg, pb, 0.005, True, 1,
                                      mesh.patch, mesh.view, seed=s,
                                      refine=G.refine)
    held("(b) view round (NCCL world of one, vp=1)", view_e, view_g,
         {"view_moments": 1 + 2 * T, "view_deviation": 1 + 2 * T,
          "sampler": 1})
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    if G.counts != {"captured": 3, "replayed": 6, "eager": 0}:
        fail(f"graphs: counts {G.counts}, expected 3 captures (flat, "
             f"chunk, view) and 6 replays")
    out["capture_s"] = caps = G.trace.seconds("refine/capture")
    out["pool_bytes"] = G.pool_bytes
    log(f"graphs (f): capture {', '.join(f'{t:.3f}' for t in caps)}"
        f" s per key (flat, chunk, view); pool {G.pool_bytes} bytes "
        f"({G.pool_bytes / 2 ** 30:.3f} GiB); peak device memory over "
        f"(a)-(c) {peak:.3f} GiB above the script's "
        f"{base_mem / 2 ** 30:.3f}")

    #     (e) ten alternating pairs each, then one profiled round each way
    for label, eager, graphed in (("flat", flat_e, flat_g),
                                  ("chunk", chunk_e, chunk_g),
                                  ("view", view_e, view_g)):
        out[label] = alternating_pairs(f"graphs (e) {label} round", eager,
                                       graphed)
    del G, view_g, flat_g, chunk_g
    torch.distributed.destroy_process_group()
    torch.cuda.synchronize()

    #     (d) and (g): -r eager and graphed, in turns, on phase 16's files
    with open(exp_path, "rb") as f:
        exp16 = f.read()
    real = cli.Reconstructor
    runs = []
    for k, graphs in enumerate((False, True, True, False)):
        d = os.path.join(work, f"graphs_r{k}")
        os.makedirs(d)
        cli.Reconstructor = functools.partial(real, graphs=graphs)
        CF.reset_launch_counts()
        t0 = time.time()
        try:
            rc, lines = run_cli(["-r", nvm, "-o", d], work)
        finally:
            cli.Reconstructor = real
        torch.cuda.synchronize()
        r_s = time.time() - t0
        if rc != 0:
            fail(f"graphs (d): -r with graphs={graphs} exit code {rc}")
        with open(os.path.join(d, "exp.mvs"), "rb") as f:
            same = f.read() == exp16
        with open(os.path.join(d, "stats.json")) as f:
            st = json.load(f)
        with open(os.path.join(d, "log.txt")) as f:
            counts, reasons = graphs_line(f.read().splitlines())
        runs.append(dict(graphs=graphs, s=r_s, launches=dict(CF.LAUNCHES),
                         counts=counts, reasons=reasons, same=same,
                         **{k_: st[k_] for k_ in (
                             "expansion_s", "expansion_device_s",
                             "expansion_refine_host_s", "refine_host_s",
                             "seed_refine_s", "refine_graph_capture_s",
                             "refine_graph_pool_bytes",
                             "expansion_refined")}))
        log(f"graphs (d) -r graphs={graphs}: {r_s:.1f} s; exp.mvs "
            f"{'byte-equal to' if same else 'DIFFERS from'} phase 16's; "
            f"launches {runs[-1]['launches']}; log: {counts}, eager "
            f"reasons {reasons}; (g) expansion {st['expansion_s']:.3f} s, "
            f"the refines' spans {st['expansion_device_s']:.3f} s, host "
            f"inside _refine_all_async {st['expansion_refine_host_s']:.3f} "
            f"s (seed stage and expansion {st['refine_host_s']:.3f} s), "
            f"seeds {st['seed_refine_s']:.3f} s; captures "
            f"{st['refine_graph_capture_s']:.3f} s, pool "
            f"{st['refine_graph_pool_bytes']} bytes")
    for r in runs:
        if not r["same"]:
            fail(f"graphs (d): -r with graphs={r['graphs']} wrote other "
                 f"exp.mvs bytes than phase 16")
        if r["launches"] != runs[0]["launches"]:
            fail(f"graphs (d): launch totals {r['launches']} against "
                 f"{runs[0]['launches']}")
        c = r["counts"]
        if r["graphs"] and not (1 <= c["captured"] <= 6 and c["replayed"]
                                and c["eager"] == 0):
            fail(f"graphs (d): the graphed -r logged {c} (expected 1-6 "
                 f"captures, replays, no eager refine)")
        if not r["graphs"] and (c["captured"] or c["replayed"]
                                or not c["eager"]):
            fail(f"graphs (d): the eager -r logged {c}")
    out["r"] = runs
    return out


def held_exit(label, refine, graphed, G):
    """The key's first call and two replays (seeds 100-102) against the
    eager refine at the same seed with the exit and with the fixed loop:
    every PatchBatch field and the iterations equal. The capture holds
    the fixed loop, so a replay launches what the fixed loop launches,
    and the key's first call (eager, with the exit) what the exit does.
    ``refine(seed, exit_chunk)`` runs the eager refine, ``graphed(seed)``
    the graphed one. Returns each seed's launch totals (exit, fixed)."""
    import torch
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    totals = []
    for seed in (100, 101, 102):
        le = []
        for exit_chunk in (10, 0):
            CF.reset_launch_counts()
            res = refine(seed, exit_chunk)
            le.append(dict(CF.LAUNCHES))
            if exit_chunk:
                want = res
        if differing_fields(res, want):
            fail(f"{label} seed {seed}: the early exit differs from the "
                 f"fixed loop in {differing_fields(res, want)}")
        CF.reset_launch_counts()
        replays = G.counts["replayed"]
        got = graphed(seed)
        torch.cuda.synchronize()
        lg = dict(CF.LAUNCHES)
        expect = le[1] if G.counts["replayed"] > replays else le[0]
        diff = differing_fields(got, want)
        if diff or lg != expect:
            fail(f"{label} seed {seed}: the graphed refine differs from "
                 f"the eager one in {diff}; launches graphed {lg}, eager "
                 f"with the exit {le[0]}, fixed loop {le[1]}")
        totals.append(tuple(le))
    log(f"{label}: the first call (eager, then the capture) and two "
        f"replays bit-equal to the eager refine with the exit and with the "
        f"fixed loop at their seeds, every PatchBatch field and the "
        f"iterations; launches per seed (exit, fixed loop = a replay's): "
        f"{totals}")
    return totals


def exit_phase(scene, cfg, pb, nvm, work, d22, rsc2, n_seeds, ref16,
               tol) -> dict:
    """Phase 26: the refine at ``psoExitChunk = 10`` captured (the
    capture holds the fixed loop, bit-identical to the early exit), and
    ``expand_step``'s refine of the whole budget replayed. (a) the flat
    seed round at the bench workload and (b) the expansion chunk in a
    search box narrower than the convergence threshold, where every swarm
    freezes early: held bit-equal to the exit and to the fixed loop
    (``held_exit``), the eager exit skipping iterations in (b); (a)'s
    ten alternating pairs; (c) the view round through an NCCL world of
    one; (d) ``-r --distributed-expansion`` on phase 16's files eager and
    graphed in turns, twice each: every exp.mvs byte-equal to phase 22's,
    the logged counts (graphed: no eager refine), the wall,
    ``dist_device_s`` and its split into the refines' spans and the
    rest; phase 22's gates. Returns the numbers."""
    import torch
    from pais_mvs_tpu_torch import cli
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    from pais_mvs_tpu_torch.ops.graphs import RefineGraphs
    from pais_mvs_tpu_torch.parallel.distributed import init_distributed
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh

    out = {}
    dev = pb.device
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    G = RefineGraphs()

    #     (a) the flat seed round, P = 30, T = 60, chunks of 10
    ca = cfg.replace(pso_exit_chunk=10)
    T = 2 * ca.max_iteration
    flat = lambda s, e=10: lc.refine_batch(
        scene, ca.replace(pso_exit_chunk=e), pb, 0.005, True, 1,
        generator=gen(s))
    flat_g = lambda s: G.refine(scene, ca, pb, 0.005, True, 1,
                                generator=gen(s))
    out["a_launches"] = held_exit(
        f"exit (a) flat seed round (B={pb.capacity}, P="
        f"{2 * ca.particle_num}, T={T}, psoExitChunk 10: nch {T // 10})",
        flat, flat_g, G)
    out["a"] = alternating_pairs("exit (a) flat seed round", flat, flat_g)

    #     (b) the expansion chunk (P = 15, T = 30: nch 3) with the normal
    #     cone narrowed to +-pi/300: every swarm's box is a few hundredths
    #     wide, so the swarms freeze within the first chunks
    cb = ca.replace(reduce_normal_range=300.0)
    chunk = lambda s, e=10: lc.refine_batch(
        scene, cb.replace(pso_exit_chunk=e), pb, 0.005, False, 1,
        generator=gen(s))
    chunk_g = lambda s: G.refine(scene, cb, pb, 0.005, False, 1,
                                 generator=gen(s))
    out["b_launches"] = held_exit(
        f"exit (b) expansion chunk, normal cone +-pi/300 (B="
        f"{pb.capacity}, P={cb.particle_num}, T={cb.max_iteration}, nch "
        f"{cb.max_iteration // 10})", chunk, chunk_g, G)
    if not all(le["fitness"] < lf["fitness"]
               for le, lf in out["b_launches"]):
        fail(f"exit (b): K1 launches (exit, fixed loop) "
             f"{out['b_launches']}: the early exit skipped no chunk")
    out["b_ms"] = [event_ms(lambda: fn(400)) for fn in (chunk, chunk_g)]
    log(f"exit (b): one call each way (CUDA events, host clock): eager "
        f"{out['b_ms'][0][0]:.2f} / {out['b_ms'][0][1]:.2f} ms, graphed "
        f"(the fixed loop) {out['b_ms'][1][0]:.2f} / "
        f"{out['b_ms'][1][1]:.2f} ms")

    #     (c) the view round through an NCCL world of one
    init_distributed(f"tcp://localhost:{free_port()}", 0, 1,
                     backend="nccl", device="cuda")
    mesh = make_mesh((1, 1))
    block = scene.view_block(0, 1)
    view_e = lambda s, e=10: lc.refine_batch(
        block, ca.replace(pso_exit_chunk=e), pb, 0.005, True, 1,
        draws=view_draws(s), view=mesh.view)
    view_g = lambda s: G.refine(block, ca, pb, 0.005, True, 1,
                                draws=view_draws(s), view=mesh.view)
    view_draws = lambda s: lc.refine_draws(pb.capacity, ca, True, 1,
                                           gen(s), dev)
    out["c_launches"] = held_exit("exit (c) view round (NCCL world of "
                                  "one, psoExitChunk 10)", view_e, view_g,
                                  G)
    # replays: (a) 2 + 10 pairs + 1 profiled, (b) 2 + 1 timed, (c) 2
    if G.counts != {"captured": 3, "replayed": 18, "eager": 0}:
        fail(f"exit (a)-(c): counts {G.counts}, expected 3 captures and 18 "
             f"replays")
    caps = G.trace.seconds("refine/capture")
    log(f"exit (a)-(c): captures {', '.join(f'{t:.3f}' for t in caps)}"
        f" s (flat, chunk, view); pool {G.pool_bytes} bytes")
    del G, flat_g, chunk_g, view_g
    torch.distributed.destroy_process_group()
    torch.cuda.synchronize()

    #     (d) -r --distributed-expansion eager and graphed, in turns
    with open(os.path.join(d22, "exp.mvs"), "rb") as f:
        exp22 = f.read()
    real = cli.Reconstructor
    runs = []
    for k, graphs in enumerate((False, True, True, False)):
        d = os.path.join(work, f"exit_dist{k}")
        os.makedirs(d)
        cli.Reconstructor = functools.partial(real, graphs=graphs)
        t0 = time.time()
        try:
            rc, _ = run_cli(["-r", nvm, "--distributed-expansion", "-o", d],
                            work)
        finally:
            cli.Reconstructor = real
        torch.cuda.synchronize()
        r_s = time.time() - t0
        if rc != 0:
            fail(f"exit (d): -r --distributed-expansion with graphs="
                 f"{graphs} exit code {rc}")
        with open(os.path.join(d, "exp.mvs"), "rb") as f:
            same = f.read() == exp22
        with open(os.path.join(d, "log.txt")) as f:
            counts, reasons = graphs_line(f.read().splitlines())
        st, cloud, med = r_gates(f"exit (d) graphs={graphs}", d, rsc2,
                                 n_seeds)
        rest = st["dist_device_s"] - st["dist_refine_device_s"]
        runs.append(dict(graphs=graphs, s=r_s, same=same, counts=counts,
                         reasons=reasons, rest_s=rest, **{k_: st[k_] for k_ in (
                             "dist_expansion_s", "dist_device_s",
                             "dist_refine_device_s", "dist_rounds",
                             "live_patches", "refine_graph_capture_s")}))
        log(f"exit (d) -r --distributed-expansion graphs={graphs}: "
            f"{r_s:.1f} s; exp.mvs {'byte-equal to' if same else 'DIFFERS from'}"
            f" phase 22's; {st['live_patches']} patches, "
            f"{st['dist_rounds']} rounds; expansion "
            f"{st['dist_expansion_s']:.3f} s, the steps' spans "
            f"(dist_device_s) {st['dist_device_s']:.3f} s = the refines' "
            f"spans {st['dist_refine_device_s']:.3f} s + the rest "
            f"{rest:.3f} s; captures {st['refine_graph_capture_s']:.3f} s; "
            f"log: {counts}, eager reasons {reasons}; median {med:.6f}")
    for r in runs:
        if not r["same"]:
            fail(f"exit (d): graphs={r['graphs']} wrote other exp.mvs bytes "
                 f"than phase 22")
        c = r["counts"]
        if r["graphs"] and not (c["captured"] and c["replayed"]
                                and c["eager"] == 0):
            fail(f"exit (d): the graphed run logged {c} (expected "
                 f"captures, replays, no eager refine)")
        if not r["graphs"] and (c["captured"] or c["replayed"]):
            fail(f"exit (d): the eager run logged {c}")
    ag, ratio = agreement_gates("exit (d) vs phase 16", cloud, ref16, tol)
    log(f"exit (d): against phase 16's cloud agreement {ag[0]:.3f} / "
        f"{ag[1]:.3f} at half a cell, count ratio {ratio:.3f}")
    out["d"] = runs
    return out


# phase 27: the JAX package's record of tools/tpu_4k_run.py at 400 seeds
# and 24 rounds (BASELINE.md:376-390): 69,954 patches from 399/400 seeds
# at median surface distance 2.04e-4; a yardstick of counts and quality,
# never of time or memory
JAX_4K_PATCHES, JAX_4K_MEDIAN = 69_954, 2.04e-4
# the port's own clouds as PERF.md records them, which no change of where
# the scene is built may move: phase 16's (seeds accepted, patches, median
# to six decimals) and phase 27's (seeds, patches, median, refines)
R_CLOUD = (153, 11_308, "0.001573")
FOURK_CLOUD = (399, 69_940, 0.00018799459905110405, 377_352)
FOURK_SEEDS, FOURK_ROUNDS = 400, 24
# the 4K render's deadline, in seconds from its start in phase 1
RENDER_4K_S = 700


def render_4k(out_dir):
    """Phase 27's files (``chip_smoke.py --render-4k DIR``): gpu_4k_run's
    8-camera 4096x3072 scene at 400 seeds written into DIR, and its ground
    truth (the scene without its images) pickled beside them."""
    import dataclasses
    sys.path.insert(0, HERE)
    from pais_mvs_tpu_torch.tools import gpu_4k_run as G4
    t0 = time.time()
    sc = G4.write_scene(out_dir, seeds=FOURK_SEEDS)
    with open(os.path.join(out_dir, "truth.pkl"), "wb") as f:
        pickle.dump(dataclasses.replace(sc, images=[]), f)
    print(f"4K scene rendered and written in {time.time() - t0:.1f} s",
          flush=True)


def fourk_phase(render, gen):
    """Phase 27: the main path at 4K. Joins the render started in phase 1
    (``render``: its directory, processes, log and start time), runs
    ``gpu_4k_run.run`` on its files at 400 seeds and 24 rounds with the
    launch counts set to 0 just before, and gates the run: phase 16's
    gates, >= 0.9 x 400 seeds accepted, the cloud within [0.7, 1.43] x the
    JAX record's 69,954 patches, median surface distance <= 3.1e-4 (1.5x
    its 2.04e-4), the path's kernels (``path_launch_gate``), the cloud
    exactly the recorded one (``FOURK_CLOUD``), no eager refine
    (each key's first run is its capture's). Then K1 and K2 against their
    twins on the run's own scene and configuration (``check_r_shapes``).
    Returns (launches, K1's max |err|, K2's)."""
    import torch
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.tools import gpu_4k_run as G4
    out_dir, procs, render_log, t_render = render
    t_phase = time.time()
    join_children("the 4K render", procs, t_render + RENDER_4K_S,
                  [render_log])
    with open(render_log) as f:
        log(f"4K render ({f.read().strip()}) joined "
            f"{time.time() - t_phase:.1f} s into phase 27")
    with open(os.path.join(out_dir, "truth.pkl"), "rb") as f:
        truth = pickle.load(f)
    keep = []
    torch.cuda.synchronize()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    CF.reset_launch_counts()
    res = G4.run(out_dir, truth, rounds=FOURK_ROUNDS, keep=keep)
    torch.cuda.synchronize()
    launches = dict(CF.LAUNCHES)
    rec = keep[0]
    log(f"4K run: {json.dumps(res)}")
    with open(os.path.join(out_dir, "log.txt")) as f:
        eager_logged = "refine runs eagerly" in f.read()
    st, c, med = r_gates("4K -r", out_dir, truth, FOURK_SEEDS)
    a = rec.arena
    lods = np.bincount(a.data["lod"][a.live_ids()],
                       minlength=rec.scene.pyramids.num_levels)
    ratio = len(c) / JAX_4K_PATCHES
    log(f"4K -r: seeds {st['seed_accepted']}/{FOURK_SEEDS}, "
        f"{len(c)} patches = {ratio:.3f} x the JAX record's "
        f"{JAX_4K_PATCHES}, median {med:.6g} (JAX {JAX_4K_MEDIAN}), "
        f"{res['expansion_rounds']} rounds; launches {launches}; the "
        f"script's allocation before the run {base_gib:.3f} GiB; the "
        f"cloud's LOD levels {lods}")
    if st["seed_accepted"] < 0.9 * FOURK_SEEDS:
        fail(f"4K -r: {st['seed_accepted']}/{FOURK_SEEDS} seeds accepted "
             f"(gate >= 90%)")
    if not 0.7 <= ratio <= 1.43:
        fail(f"4K -r: {len(c)} patches, {ratio:.3f} x the JAX record "
             f"(gate [0.7, 1.43])")
    if not med <= 3.1e-4:
        fail(f"4K -r: median surface distance {med:.6g} (gate <= 3.1e-4)")
    if res["expansion_rounds"] > FOURK_ROUNDS:
        fail(f"4K -r: {res['expansion_rounds']} rounds past the cap")
    path_launch_gate("4K -r", launches)
    cloud = (st["seed_accepted"], len(c), med, res["expansion_refined"])
    if cloud != FOURK_CLOUD:
        fail(f"4K -r: the cloud {cloud} (seeds, patches, median, refines) "
             f"is not the recorded {FOURK_CLOUD}")
    if res["refine_graphs"]["eager"] or eager_logged \
            or not res["refine_graphs"]["captured"]:
        fail(f"4K -r: refine graphs {res['refine_graphs']}, eager refine "
             f"logged: {eager_logged}; every refine graphed expected")
    if len(truth.seed_centers) < 256:
        fail(f"4K -r: {len(truth.seed_centers)} seeds, 256 rows wanted "
             f"for the kernel checks")
    err1, err2 = check_r_shapes(rec, (truth.seed_centers,
                                      truth.seed_cam_masks,
                                      truth.seed_img_points), gen,
                                label="4K -r shape")
    del rec, keep
    torch.cuda.empty_cache()
    log(f"phase 27 (4K -r): {time.time() - t_phase:.1f} s")
    return launches, err1, err2


# what each scene-build kernel stands in for: no Pallas kernel (the JAX
# package builds its scene in numpy), so the numpy step's file:line
PYRAMID_REPLACES = {
    "pyramid_gray": "pais_mvs_tpu/ops/pyramid.py:25",
    "pyramid_col_scan": "pais_mvs_tpu/ops/pyramid.py:44",
    "pyramid_row_scan": "pais_mvs_tpu/ops/pyramid.py:74",
    "pyramid_resample_rows": "pais_mvs_tpu/ops/pyramid.py:48",
    "pyramid_resample_cols": "pais_mvs_tpu/ops/pyramid.py:74",
    "pyramid_edge_range": "pais_mvs_tpu/ops/pyramid.py:77",
    "pyramid_pack": "pais_mvs_tpu/ops/pyramid.py:191",
}


def config_from_txt(text: str):
    """An MvsConfig from config.txt text, as the CLI reads it."""
    from pais_mvs_tpu_torch.config import load_config_txt
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config.txt")
        with open(path, "w") as f:
            f.write(text)
        return load_config_txt(path)


def same_bits(a, b) -> bool:
    """Two tensors of one dtype and shape hold the same bits (a may lie on
    the card)."""
    import torch
    a = a.cpu()
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def scene_build_check(label, params, images, cfg, dev) -> dict:
    """``build_scene`` on the card (the kernels of csrc/pyramid.cu) and on
    the CPU (their plain twins) from the same images: every atlas, dims,
    yoff and the colour plane must hold the same bits. Returns the two
    builds' seconds and the card's split."""
    import dataclasses
    import torch
    from pais_mvs_tpu_torch.models.camera import build_scene
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    split = {}
    t0 = time.perf_counter()
    card = build_scene(params, images, cfg, device=dev, split=split)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    scene_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    t0 = time.perf_counter()
    cpu = build_scene(params, images, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    for f in dataclasses.fields(cpu.pyramids):
        if not same_bits(getattr(card.pyramids, f.name),
                         getattr(cpu.pyramids, f.name)):
            fail(f"scene build {label}: the card's {f.name} differs from "
                 f"the CPU twins' build")
    log(f"scene build {label}: {len(images)} cameras, atlas "
        f"{tuple(card.pyramids.images.shape)}; every atlas, dims, yoff and "
        f"rgb bit-equal to the CPU twins' build; build_scene on the card "
        f"{card_s:.3f} s (undistort {split['undistort_s']:.4f}, uploads "
        f"{split['upload_s']:.4f}, kernels {split['kernel_s']:.4f} s by "
        f"CUDA events), on the CPU {cpu_s:.3f} s; device memory: the scene "
        f"{scene_gib:.3f} GiB, the build's peak {peak_gib:.3f} GiB")
    return dict(card_s=card_s, cpu_s=cpu_s, scene_GiB=scene_gib,
                peak_GiB=peak_gib, **split)


def pyramid_kernel_rows(img, cfg, dev) -> dict:
    """Each scene-build kernel at one camera's shapes (``img``: its uint8
    RGB), level 0 and level 1 as the build runs them: against its plain
    twin on CPU copies of the same inputs (every output bit-equal, so the
    max |err| is 0), its device time (``time_ms``), the twin's host time,
    ``torch.cumsum`` on the card beside the two scans (the library's
    running sum over the same float64 plane, without the zero row), and
    its bound: the bytes its inputs need read once and its outputs written
    once over the memory rate, or its float64 operations over the FP64
    rate, whichever is larger. Returns {entry: row}."""
    import torch
    from pais_mvs_tpu_torch.ops import pyramid as PY
    h, w = img.shape[:2]
    dims = PY.level_dims(h, w, cfg.lod_ratio,
                         PY.max_lod_for(w, h, cfg.lod_ratio, cfg.max_lod))
    yoff, wa = PY.atlas_offsets([dims], len(dims))
    h1, w1 = (int(v) for v in dims[1])
    up_h = PY.host_tensor(img)
    up = up_h.to(dev)
    rgb = torch.zeros((h, w, 3), dtype=torch.uint8, device=dev)
    g = PY.gray_plane(up, rgb)
    F = PY.antiderivative(g)
    tmp = PY.resample_rows(g, F, h1)
    G = PY.row_antiderivative(tmp)
    M = PY.moment_antiderivative(g)
    I = PY.row_antiderivative(M)
    lohi = PY.edge_range(g)
    planes = [torch.zeros((int(yoff[-1]), wa), dtype=torch.bfloat16,
                          device=dev) for _ in range(3)]
    c = {k: v.cpu() for k, v in dict(g=g, F=F, tmp=tmp, G=G, M=M, I=I,
                                     lohi=lohi).items()}
    planes_h = [p.cpu() for p in planes]
    rgb_h = rgb.cpu()
    def pack(g_, lohi_, I_, planes_):
        PY.pack_level(g_, lohi_, I_, cfg.patch_radius, 0, *planes_)
        return planes_

    D = 8
    # entry: (card call, twin call, bytes, FP64 operations, library call)
    steps = {
        "pyramid_gray": (
            lambda: (PY.gray_plane(up, rgb), rgb),
            lambda: (PY.gray_plane(up_h, rgb_h), rgb_h),
            h * w * (3 + D + 3), 6 * h * w, None),
        "pyramid_col_scan": (
            lambda: (PY.antiderivative(g),),
            lambda: (PY.antiderivative(c["g"]),),
            h * w * D + (h + 1) * w * D, h * w,
            lambda: torch.cumsum(g, 0)),
        "pyramid_col_scan_moments": (
            lambda: (PY.moment_antiderivative(g),),
            lambda: (PY.moment_antiderivative(c["g"]),),
            h * w * D + 2 * (h + 1) * w * D, 3 * h * w, None),
        "pyramid_row_scan": (
            lambda: (PY.row_antiderivative(tmp),),
            lambda: (PY.row_antiderivative(c["tmp"]),),
            h1 * w * D + h1 * (w + 1) * D, h1 * w,
            lambda: torch.cumsum(tmp, 1)),
        "pyramid_row_scan_moments": (
            lambda: (PY.row_antiderivative(M),),
            lambda: (PY.row_antiderivative(c["M"]),),
            2 * (h + 1) * w * D + 2 * (h + 1) * (w + 1) * D, 2 * (h + 1) * w,
            None),
        # the gathers read the rows of f and F at the h1 + 1 edges
        "pyramid_resample_rows": (
            lambda: (PY.resample_rows(g, F, h1),),
            lambda: (PY.resample_rows(c["g"], c["F"], h1),),
            2 * (h1 + 1) * w * D + h1 * w * D, 12 * h1 * w, None),
        "pyramid_resample_cols": (
            lambda: (PY.resample_cols(tmp, G, w1),),
            lambda: (PY.resample_cols(c["tmp"], c["G"], w1),),
            2 * h1 * (w1 + 1) * D + h1 * w1 * D, 14 * h1 * w1, None),
        "pyramid_edge_range": (
            lambda: (PY.edge_range(g),),
            lambda: (PY.edge_range(c["g"]),),
            h * w * D + 2 * D, 6 * h * w, None),
        "pyramid_pack": (
            lambda: pack(g, lohi, I, planes),
            lambda: pack(c["g"], c["lohi"], c["I"], planes_h),
            h * w * D + 2 * (h + 1) * (w + 1) * D + 2 * D + 3 * h * w * 2,
            20 * h * w, None),
    }
    rows = {}
    for name, (card, plain, nbytes, ops, library) in steps.items():
        got = card()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = 0.0
        for a, b in zip(got, want):
            if not same_bits(a, b):
                fail(f"{name} at {h}x{w}: the kernel's output differs from "
                     f"its plain twin's")
            if a.dtype != torch.uint8:
                err = max(err, float((a.cpu().double() - b.double()).abs()
                                     .max()))
        ms, host_ms = time_ms(card, reps=5)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP64_OPS_PER_S * 1e3
        rows[name] = dict(
            ms=ms, host_ms=host_ms, plain_ms=plain_ms, max_abs_err=err,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=time_ms(library, reps=5)[0] if library else None)
        log(f"{name} at {h}x{w} (level 1 {h1}x{w1}): bit-equal to its twin; "
            f"{ms:.4f} ms device, {host_ms:.4f} ms host, bound "
            f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}), "
            f"twin {plain_ms:.1f} ms on the host"
            + (f", torch.cumsum {rows[name]['library_ms']:.4f} ms"
               if library else ""))
    return rows


def scene_phase(rsc2, render_dir, dev):
    """Phase 28: the scene build on the card against the CPU twins: the
    pawn rig at 2x under phase 16's configuration, and two of phase 27's
    4096x3072 cameras from its files under its configuration; then each
    kernel of csrc/pyramid.cu at the 4K camera's shapes
    (``pyramid_kernel_rows``). Returns (the builds' numbers, the rows)."""
    from PIL import Image
    from pais_mvs_tpu_torch.config import load_config_txt
    from pais_mvs_tpu_torch.io import nvm as nvm_io
    t_phase = time.time()
    out = {"pawn_2x": scene_build_check(
        "pawn rig at 2x", rsc2.params, rsc2.images,
        config_from_txt(REAL_CONFIG_TXT), dev)}
    cams = nvm_io.load_nvm(os.path.join(render_dir, "scene.nvm")).cameras[:2]
    images = [np.asarray(Image.open(os.path.join(render_dir, p.file_name))
                         .convert("RGB")) for p in cams]
    cfg4k = load_config_txt(os.path.join(render_dir, "config.txt"))
    out["4k_two"] = scene_build_check("4K, two cameras", cams, images, cfg4k,
                                      dev)
    rows = pyramid_kernel_rows(images[0], cfg4k, dev)
    log(f"phase 28 (scene build on the card): {time.time() - t_phase:.1f} s")
    return out, rows


def ptxas_usage(log: str) -> dict:
    """{kernel (mangled name): {"registers", "spill_stores", "spill_loads"}}
    from ``nvcc -Xptxas -v`` output."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            usage[fn].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["registers"] = int(m.group(1))
    return usage


def microbench_library(box):
    """The library yardstick of M, sampling only: ``grid_sample`` on the
    bf16-rounded boxes at M's 5120 x 1024 x 30 sample points (column u + p
    mod 17, row v: where the two hats of a (pixel, particle) centre),
    summed over particles. Not the same function: its weights are not
    rounded to bf16 and it has no 64-column clip. Returns the call."""
    import torch
    import torch.nn.functional as TNF
    from pais_mvs_tpu_torch.tools import microbench_kernel as MB
    nbox = box.shape[0]
    per = MB.CELLS // nbox
    t = torch.arange(MB.T, dtype=torch.float32, device=box.device)
    p = torch.arange(MB.P, device=box.device)
    x = (MB.U0 + 0.03 * t)[None, :] + p[:, None].float() \
        + (p % 17)[:, None].float()                           # [P, T]
    y = (MB.V0 + 0.01 * t)[None, :].expand(MB.P, MB.T)
    g = torch.stack([x / (MB.KX - 1) * 2 - 1, y / (MB.KY - 1) * 2 - 1], -1)
    grid = g[None, None].expand(nbox, per, MB.P, MB.T, 2).reshape(
        nbox, per * MB.P, MB.T, 2).contiguous()
    img = box.to(torch.bfloat16).float()[:, None]            # [n, 1, 80, 256]

    def call():
        return TNF.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True).view(nbox, per, MB.P, MB.T).sum(2)
    return call


# phase 29's rig: the Middlebury temple's 312 views at 640x480 on a
# hemisphere (benchmark/configs/middlebury-temple.json), r = 15, PSO 15 x 30
MANY_VIEWS = {"width": 640, "height": 480, "cameras": 312, "focal": 1520.0,
              "seeds": 400, "scene_seed": 11, "config_txt": {}}
# the cameras a row sees in phase 29's table: rows past the tile from 33,
# and the temple's widest rows (114); the phase adds both sides of a wide
# block's span (cuda_fitness.CAMERA_SPAN: one pass; one camera more: two)
MANY_VIEWS_SEEN = (8, 32, 33, 64, 90, 114, 160)


def many_views_phase(dev):
    """29. K1 past its camera tile on the 312-view hemisphere rig: the
    seeds with their own views (up to ~110), each row's ``CAMERA_TILE``
    + 1 and ``CAMERA_SPAN`` + 1 best-facing cameras, and every camera of
    the rig, against the plain twin (exact BIG set, 1e-4 relative above
    1); the launches of one expansion-mode refine of 1024 rows (K1 1 + 30,
    K2 1, no other); then K1's device time at B = 1024, P = 15 against the
    cameras a row sees (its ``MANY_VIEWS_SEEN``, ``CAMERA_SPAN`` and
    ``CAMERA_SPAN`` + 1 best-facing ones), each held to the twin on 64
    rows, with the share of the FP32 bound (each sample's operations
    once). Returns (launches, max |err|, table rows)."""
    import torch
    from benchmark.scenes import hemisphere_object as HO
    from pais_mvs_tpu_torch.config import MvsConfig
    from pais_mvs_tpu_torch.models import patch as pm
    from pais_mvs_tpu_torch.models.camera import CameraParams, build_scene
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import fitness as F
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    t0 = time.time()
    sc = HO.render(MANY_VIEWS, 1, dev)
    params = [CameraParams(file_name=c.name, focal=np.array([c.focal] * 2),
                           principal=np.array([-1.0, -1.0]),
                           quaternion=np.asarray(c.quaternion),
                           center=np.asarray(c.center)) for c in sc.cameras]
    B, P, T = 1024, 15, 30
    cfg = MvsConfig(patch_radius=15, particle_num=P, max_iteration=T,
                    dist_weighting=5.0, batch_size=B)
    scene = build_scene(params, sc.images, cfg, device=dev)
    del sc.images
    pb = lc.prepare_seeds(scene, cfg, pm.from_seeds(
        sc.seed_points, sc.seed_masks, sc.seed_pixels, device=dev))
    pb = pm.take(pb, np.arange(B) % pb.capacity)
    seen = pb.cam_mask.sum(1)
    log(f"many-view rig: {scene.num_cameras} cameras at "
        f"{MANY_VIEWS['width']}x{MANY_VIEWS['height']}, "
        f"{len(sc.seed_points)} seeds seeing {int(seen.min())}-"
        f"{int(seen.max())} cameras, {int((seen > CF.CAMERA_TILE).sum())} "
        f"of {B} rows past the {CF.CAMERA_TILE}-camera tile; "
        f"{time.time() - t0:.1f} s")
    if int(seen.max()) <= CF.CAMERA_TILE:
        fail("many-view rig: no row sees more cameras than K1's tile")

    def best_facing(normal, k):
        """[B, C] masks of each row's k cameras that best face it."""
        face = -(normal @ scene.rig.optical.T)
        top = torch.topk(face, k, dim=1).indices
        return torch.zeros(face.shape, dtype=torch.bool,
                           device=dev).scatter_(1, top, True)

    # K1 against the plain twin, selftest noise, on 128 rows
    err = 0.0
    sub = pm.take(pb, np.arange(128))
    n = sub.normal()
    for label, mask in (("own views", sub.cam_mask),
                        (f"{CF.CAMERA_TILE + 1} best-facing",
                         best_facing(n, CF.CAMERA_TILE + 1)),
                        (f"{CF.CAMERA_SPAN + 1} best-facing",
                         best_facing(n, CF.CAMERA_SPAN + 1)),
                        ("every camera", torch.ones_like(sub.cam_mask))):
        _, ref, lod, ray, pos = selftest_inputs(
            scene, cfg, sub.replace(cam_mask=mask), 128, 16, 29)
        err = max(err, check_fitness(f"many-view rig, {label}", scene, cfg,
                                     ref, mask, lod, ray, pos)[0])

    # the launches of one expansion-mode refine of the B rows
    gen = torch.Generator(dev).manual_seed(29)
    torch.cuda.synchronize()
    CF.reset_launch_counts()
    res = lc.refine_batch(scene, cfg, pb, 0.005, False, 1, generator=gen)
    torch.cuda.synchronize()
    launches = dict(CF.LAUNCHES)
    if launches != {**dict.fromkeys(CF.LAUNCHES, 0), "fitness": 1 + T,
                    "sampler": 1}:
        fail(f"many-view refine launch counts {launches}, expected fitness "
             f"{1 + T} (1 + {T} PSO evaluations), sampler 1 and no other")
    if not bool(torch.isfinite(res.batch.center[res.batch.valid]).all()):
        fail("many-view refine: non-finite centres among accepted patches")
    log(f"many-view refine (B={B}, P={P}, T={T}): launches {launches}, "
        f"accepted {int(res.batch.valid.sum())}/{B}")

    # K1's time against the cameras a row sees
    n = pb.normal()
    rng = np.random.default_rng(29)
    rows = []
    for k in sorted({*MANY_VIEWS_SEEN, CF.CAMERA_SPAN, CF.CAMERA_SPAN + 1}):
        mask = best_facing(n, k)
        ref = lc.set_reference_camera(scene, n, mask)
        depth, ray = lc.set_depth_and_ray(scene, pb.center, ref)
        lod = lc.set_lod(scene, cfg, pb.center, ref)
        noise = torch.tensor(rng.normal(size=(B, P, 3))
                             * [0.05, 0.05, 0.001], dtype=torch.float32,
                             device=dev)
        pos = torch.stack([pb.normal_sph[:, 0], pb.normal_sph[:, 1], depth],
                          -1)[:, None, :] + noise
        H, pt, pv = F.fitness_geometry(scene, cfg, ref, mask, lod, ray, pos)
        args = (scene.pyramids, cfg, H, pt, ref, mask, lod, pv)
        got = CF.score_windows(*args)
        few = tuple(x[:64] if torch.is_tensor(x) else x for x in args)
        err = max(err, compare_fitness(f"K1 many-view rig, {k} cameras a "
                                       f"row", got[:64], F.score_windows(
                                           *few)))
        ms, host = time_ms(lambda: CF.score_windows(*args), 20)
        ops = float((pv.sum(1) * (2 * cfg.patch_radius + 1) ** 2
                     * (mask.sum(1) * K1_OPS_SAMPLE + K1_OPS_PIXEL)).sum())
        bound = ops / FP32_OPS_PER_S * 1e3
        row = {"cams_per_row": k, "ms": ms, "host_ms": host,
               "bound_ms": bound, "roofline_pct": 100.0 * bound / ms,
               "scored": int((got < 1e20).sum())}
        log(f"K1 many-view rig, {k} cameras a row: {json.dumps(row)}")
        rows.append(row)
    del scene, pb, res
    torch.cuda.empty_cache()
    return launches, err, rows


def many_views_main():
    """Phase 29 alone (``chip_smoke.py --many-views``), after the kernels'
    build; its last line is ``{"ok": true, "many_views": {...}}``."""
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this phase needs a CUDA "
             "GPU", code=2)
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    CF.build_kernels()
    launches, err, rows = many_views_phase(torch.device("cuda"))
    print(json.dumps({"ok": True, "many_views": {
        "card": card, "launches": launches, "max_abs_err": err,
        "k1": rows}}), flush=True)


def main():
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA GPU", code=2)
    try:
        import pais_mvs_tpu_torch
    except ImportError as e:
        fail(f"the package pais_mvs_tpu_torch is not beside this script "
             f"({e})", code=2)
    if not os.path.abspath(pais_mvs_tpu_torch.__file__).startswith(
            os.path.join(HERE, "pais_mvs_tpu_torch")):
        fail("pais_mvs_tpu_torch was imported from outside this checkout: "
             f"{pais_mvs_tpu_torch.__file__}", code=2)
    from pais_mvs_tpu_torch.config import MvsConfig
    from pais_mvs_tpu_torch.data.realistic import make_realistic_scene
    from pais_mvs_tpu_torch.data.synthetic import make_scene
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    from pais_mvs_tpu_torch.io import mvsbin
    from pais_mvs_tpu_torch.io.pointcloud import read_ply
    from pais_mvs_tpu_torch.models import patch as pm
    from pais_mvs_tpu_torch.models.camera import build_scene
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import fitness as F
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    from pais_mvs_tpu_torch.ops import view_fitness as VF
    from pais_mvs_tpu_torch.ops.pso import draw_uniforms
    from pais_mvs_tpu_torch.parallel.distributed import init_distributed
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    from pais_mvs_tpu_torch.parallel.sharded import refine_sharded
    from pais_mvs_tpu_torch.tools import microbench_kernel as MB

    t_start = time.time()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    # phase 27's files: gpu_4k_run's 4K scene, rendered on the host by a
    # child process while the card runs phases 1-26
    render_dir = tempfile.mkdtemp(prefix="chip_smoke_4k_")
    render_log = os.path.join(render_dir, "render.log")
    render = (render_dir, start_children(
        [[sys.executable, os.path.abspath(__file__), "--render-4k",
          render_dir]], logs=[render_log]), render_log, time.time())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 1. build every kernel of the path from csrc/ (parallel nvcc)
    t0 = time.time()
    logs = CF.build_kernels()
    log(f"kernel build: {time.time() - t0:.2f} s "
        f"({', '.join(sorted(logs)) or 'cached'})")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # the real-photo texture the pawn-rig scene needs
    from pais_mvs_tpu_torch.data import realistic
    if not os.path.exists(realistic.PHOTO_PATH):
        fail(f"the real-photo texture is missing: {realistic.PHOTO_PATH}")
    photo = realistic.load_photo()
    log(f"real-photo texture: {photo.shape} {photo.dtype}")

    # scenes: bench.py:92-110 and bench.py:171-183
    B = 1024
    cfg = MvsConfig(particle_num=15, max_iteration=30, dist_weighting=5.0,
                    batch_size=B, max_lod=6)
    t0 = time.time()
    sc = make_scene(num_cams=5, width=640, height=480, num_seeds=B + 64,
                    seed=0)
    scene = build_scene(sc.params, sc.images, cfg, device=dev)
    rsc = make_realistic_scene(num_seeds=128, seed=0)
    rcfg = MvsConfig(patch_radius=6, max_lod=4, particle_num=8,
                     max_iteration=12, dist_weighting=2.0, cell_size=12,
                     min_cam_num=3, batch_size=128)
    rscene = build_scene(rsc.params, rsc.images, rcfg, device=dev)
    log(f"scenes built: {time.time() - t0:.2f} s; atlas "
        f"{tuple(scene.pyramids.images.shape)} bf16")
    rng = np.random.default_rng(0)
    centers = sc.seed_centers[:B] + rng.normal(scale=0.01, size=(B, 3))
    pb = lc.prepare_seeds(scene, cfg, pm.from_seeds(
        centers, sc.seed_cam_masks[:B], sc.seed_img_points[:B], device=dev))
    Br = (len(rsc.seed_centers) // 8) * 8
    # a 12-camera rig of the bench scene's kind, for the kernels' camera
    # loops (K1's first form refused more than 8 cameras)
    sc12 = make_scene(num_cams=12, width=640, height=480, num_seeds=320,
                      seed=1)
    scene12 = build_scene(sc12.params, sc12.images, cfg, device=dev)
    pb12 = lc.prepare_seeds(scene12, cfg, pm.from_seeds(
        sc12.seed_centers[:256], sc12.seed_cam_masks[:256],
        sc12.seed_img_points[:256], device=dev))
    log(f"12-camera rig: {pb12.capacity} seeds, up to "
        f"{int(pb12.cam_mask.sum(1).max())} visible cameras")
    rpb = lc.prepare_seeds(rscene, rcfg, pm.from_seeds(
        rsc.seed_centers[:Br], rsc.seed_cam_masks[:Br],
        rsc.seed_img_points[:Br], device=dev))

    # 2. K1 vs plain at the selftest shape (P=16), both scenes and the
    #    12-camera rig, four radii; P in {1, 7, 30} (one particle, partial
    #    tiles of 8) at r in {3, 15}; a third of the swarms inactive, all
    #    inactive, and no valid particle
    err1 = 0.0
    for label, s, c, p in (("synthetic", scene, cfg, pb),
                           ("realistic", rscene, rcfg, rpb),
                           ("12-camera", scene12, cfg, pb12)):
        sub, ref, lod, ray, pos = selftest_inputs(s, c, p, 256, 16, 7)
        for r in (3, 6, 15, 24):
            cr = c.replace(patch_radius=r, dist_weighting=r / 3.0)
            err1 = max(err1, check_fitness(f"{label} r={r}", s, cr, ref,
                                           sub.cam_mask, lod, ray, pos)[0])
        for P_ in (1, 7, 30):
            pos_p = selftest_inputs(s, c, p, 256, P_, P_)[-1]
            for r in (3, 15):
                cr = c.replace(patch_radius=r, dist_weighting=r / 3.0)
                err1 = max(err1, check_fitness(
                    f"{label} P={P_} r={r}", s, cr, ref, sub.cam_mask, lod,
                    ray, pos_p)[0])
        act = torch.arange(sub.capacity, device=dev) % 3 != 0
        err1 = max(err1, check_fitness(f"{label} r={c.patch_radius} active",
                                       s, c, ref, sub.cam_mask, lod, ray,
                                       pos, act)[0])
        check_fitness(f"{label} all inactive", s, c, ref, sub.cam_mask, lod,
                      ray, pos, torch.zeros_like(act))
        check_fitness(f"{label} no valid particle", s, c, ref, sub.cam_mask,
                      lod, ray, pos, no_valid=True)

    # 3. K2 vs plain: prepared seeds, on and off the surface, four radii,
    #    both scenes and the 12-camera rig; every camera masked
    err2 = 0.0
    for label, s, c, p in (("synthetic", scene, cfg, pb),
                           ("realistic", rscene, rcfg, rpb),
                           ("12-camera", scene12, cfg, pb12)):
        n = p.normal()
        ref = lc.set_reference_camera(s, n, p.cam_mask)
        lod = lc.set_lod(s, c, p.center, ref)
        for r in (3, 6, 15, 24):
            for shift in (0.0, 0.02):
                err2 = max(err2, check_sampler(
                    f"{label} r={r} shift={shift}", s,
                    c.replace(patch_radius=r), p.center + shift, n, ref,
                    p.cam_mask, lod)[0])
        check_sampler(f"{label} every camera masked", s, c, p.center, n, ref,
                      torch.zeros_like(p.cam_mask), lod)

    # 4. the view kernels (A: view_moments, B: view_deviation) vs plain at
    #    the selftest shape: both scenes on camera blocks of 5 and 1, the
    #    12-camera rig whole, four radii, the edge plane on and off; act
    #    switches a third of the swarms off, every third patch's reference
    #    camera is not owned (as on another view rank); then every swarm
    #    inactive and no valid particle
    errva = errvb = 0.0
    for label, s, c, p, blocks in (("synthetic", scene, cfg, pb, (5, 1)),
                                   ("realistic", rscene, rcfg, rpb, (5, 1)),
                                   ("12-camera", scene12, cfg, pb12, (12,))):
        sub, ref, lod, ray, pos = selftest_inputs(s, c, p, 256, 16, 7)
        act = torch.arange(sub.capacity, device=dev) % 3 != 0
        for cb in blocks:
            for r in (3, 6, 15, 24):
                cr = c.replace(patch_radius=r, dist_weighting=r / 3.0)
                args = view_inputs(s, cr, ref, sub.cam_mask, lod, ray, pos,
                                   cb, act)
                for edges in (False, True):
                    ea, eb = check_view_kernels(
                        f"{label} c={cb} r={r} edges={edges}", args, r,
                        edges)
                    errva, errvb = max(errva, ea), max(errvb, eb)
        for what, kw in (("all inactive", {"active": torch.zeros_like(act)}),
                         ("no valid particle", {"no_valid": True})):
            check_view_kernels(f"{label} {what}", view_inputs(
                s, c, ref, sub.cam_mask, lod, ray, pos, blocks[-1], **kw),
                c.patch_radius, True)
    del args

    # 5. the main path: one seed round at the bench workload; K1's inputs
    #    of a mid-round PSO evaluation (the 31st of 61) are kept for phase
    #    14 by a pass-through around the dispatcher
    gen = torch.Generator(device=dev).manual_seed(0)
    in_loop, score_windows = [], CF.score_windows

    def capture(*args):
        if len(in_loop) == 30:
            in_loop.append(args[:2] + tuple(
                None if t is None else t.clone() for t in args[2:]))
        else:
            in_loop.append(None)
        return score_windows(*args)

    torch.cuda.synchronize()
    CF.reset_launch_counts()
    CF.score_windows = capture
    t0 = time.time()
    try:
        res = lc.refine_batch(scene, cfg, pb, 0.005, True, 1, generator=gen)
    finally:
        CF.score_windows = score_windows
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = dict(CF.LAUNCHES)
    log(f"main path (refine_batch, seed mode, 1 round, B={B}): first run "
        f"{first_s:.2f} s, launches {launches}")
    if launches != {**dict.fromkeys(CF.LAUNCHES, 0), "fitness": 61,
                    "sampler": 1}:
        fail(f"main path launch counts {launches}, expected fitness 61 "
             f"(1 + 2x30 PSO evaluations), sampler 1 and no other")
    keep = res.batch.valid.cpu().numpy()
    d = sc.surface_distance(res.batch.center.cpu().numpy()[keep])
    med = float(np.median(d)) if keep.any() else float("inf")
    log(f"main path quality: accepted {int(keep.sum())}/{B}, median surface "
        f"distance {med:.6f}")
    if not (keep.sum() > 0.5 * B and med < 0.003):
        fail("main path misses bench.py's bar (accepted > 50%, median "
             "< 0.003)")
    if not bool(torch.isfinite(res.batch.center[res.batch.valid]).all()):
        fail("main path: non-finite centres among accepted patches")
    reps = 3
    round_ms, round_host, round_mem, out = timed_rounds(
        lambda: lc.refine_batch(scene, cfg, pb, 0.005, True, 1,
                                generator=gen), reps)
    pps = B / (round_ms / 1e3)
    log(f"main path timed: {round_ms:.2f} ms per round (CUDA events, mean "
        f"of {reps} after warm-up), {pps:.1f} refined patches/s; host "
        f"clock {round_host:.2f} ms per round; peak device memory "
        f"{round_mem:.3f} GiB; accepted {int(out.batch.valid.sum())}/{B}")

    # 6. the slice on the card vs on the CPU (plain twins), same draws
    Bs = 64
    small = pm.take(pb, np.arange(Bs))
    P, T = 2 * cfg.particle_num, 2 * cfg.max_iteration
    draws = draw_uniforms(Bs, P, 3, T,
                          generator=torch.Generator().manual_seed(5),
                          device="cpu")
    g = lc.refine_batch(scene, cfg, small, 0.005, True, 1,
                        draws=[type(draws)(*(t.to(dev) for t in draws))])
    c = lc.refine_batch(scene.to("cpu"), cfg, small.to("cpu"), 0.005, True,
                        1, draws=[draws])
    gv, cv = g.batch.valid.cpu().numpy(), c.batch.valid.numpy()
    bv = gv & cv
    dc = np.linalg.norm(g.batch.center.cpu().numpy()[bv]
                        - c.batch.center.numpy()[bv], axis=-1)
    agree = float((gv == cv).mean())
    mdc = float(np.median(dc)) if bv.any() else float("inf")
    log(f"card vs CPU slice (B={Bs}, same draws): valid agreement {agree:.3f}"
        f", accepted {int(gv.sum())} vs {int(cv.sum())}, median centre "
        f"difference {mdc:.3g}")
    if agree < 0.95 or abs(int(gv.sum()) - int(cv.sum())) > 2 or mdc > 1e-4:
        fail("the card's slice disagrees with the CPU reference")

    # 7. the real-photo pawn-rig gate (bench.py:184-191)
    rres = lc.refine_batch(rscene, rcfg, rpb, 0.01, True, 2,
                           generator=torch.Generator(device=dev)
                           .manual_seed(3))
    rkeep = rres.batch.valid.cpu().numpy()
    rd = rsc.surface_distance(rres.batch.center.cpu().numpy()[rkeep])
    rmed = float(np.median(rd)) if rkeep.any() else float("inf")
    log(f"realistic gate: {int(rkeep.sum())}/{Br} seeds, median surface "
        f"distance {rmed:.6f}")
    if not (rkeep.sum() > 0.4 * Br and rmed < 2.5e-3):
        fail("real-photo gate missed (accepted > 40%, median < 2.5e-3)")

    # 8. the seed-stage Reconstructor end to end, PLY out and back
    rec = Reconstructor(rsc.params, rsc.images,
                        rcfg.replace(seed_refine_rounds=2), verbose=False,
                        device="cuda")
    rec.load_seeds(rsc.seed_centers, rsc.seed_cam_masks,
                   rsc.seed_img_points)
    n = rec.refine_seeds()
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "seeds.ply")
        rec.write_ply(ply)
        pc, pn, _ = read_ply(ply)
    rmed2 = float(np.median(rsc.surface_distance(pc))) if n else float("inf")
    log(f"Reconstructor seed stage: {n}/{len(rsc.seed_centers)} seeds in "
        f"{rec.stats['seed_refine_s']:.2f} s ({rec.stats['seed_rounds']} "
        f"rounds), PLY {len(pc)} points, median surface distance "
        f"{rmed2:.6f}")
    if (n <= 0.4 * len(rsc.seed_centers) or len(pc) != n
            or not np.allclose(pc, rec.live_centers(), atol=1e-6)
            or not np.allclose(np.linalg.norm(pn, axis=-1), 1.0, atol=1e-5)
            or rmed2 >= 2.5e-3):
        fail("Reconstructor seed stage / PLY round trip")

    # 9. the view-sharded fitness through a real NCCL group of world size 1
    init_distributed(f"tcp://localhost:{free_port()}", 0, 1,
                     backend="nccl", device="cuda")
    mesh = make_mesh((1, 1))
    log(f"process group: NCCL, world 1, layout {mesh.shape} (dp, vp)")
    for label, s, c, p in (("synthetic", scene, cfg, pb),
                           ("realistic", rscene, rcfg, rpb)):
        sub, ref, lod, ray, pos = selftest_inputs(s, c, p, 256, 16, 7)
        check_view_fitness(label, s, c, ref, sub.cam_mask, lod, ray, pos,
                           mesh.view)

    # 10. the view path at full width: one seed round, dp=1, vp=1
    block = scene.view_block(mesh.view.index, mesh.view.size)
    view_round = lambda: refine_sharded(block, cfg, pb, 0.005, True, 1,
                                        mesh.patch, mesh.view, seed=0)
    #     the view kernels' inputs of the round's 31st evaluation are kept
    #     for phase 14 by pass-throughs around the two dispatchers
    view_in = {"view_moments": [], "view_deviation": []}
    wrapped = {k: getattr(CF, k) for k in view_in}

    def keep_31st(name):
        def call(pyrs, *args):
            if len(view_in[name]) == 30:
                view_in[name].append((pyrs,) + tuple(
                    t.clone() if torch.is_tensor(t) else t for t in args))
            else:
                view_in[name].append(None)
            return wrapped[name](pyrs, *args)
        return call

    torch.cuda.synchronize()
    CF.reset_launch_counts()
    t0 = time.time()
    try:
        for k in view_in:
            setattr(CF, k, keep_31st(k))
        vres = view_round()
    finally:
        for k, fn in wrapped.items():
            setattr(CF, k, fn)
    torch.cuda.synchronize()
    vfirst_s = time.time() - t0
    vlaunches = dict(CF.LAUNCHES)
    log(f"view path (refine_sharded, dp=1 vp=1, 1 round, B={B}): first "
        f"run {vfirst_s:.2f} s, launches {vlaunches}")
    if vlaunches != {**dict.fromkeys(CF.LAUNCHES, 0), "view_moments": 61,
                     "view_deviation": 61, "sampler": 1}:
        fail(f"view path launch counts {vlaunches}, expected view_moments "
             f"61, view_deviation 61, sampler 1 and no other (fitness 0)")
    vkeep = vres.batch.valid.cpu().numpy()
    vd = sc.surface_distance(vres.batch.center.cpu().numpy()[vkeep])
    vmed = float(np.median(vd)) if vkeep.any() else float("inf")
    log(f"view path quality: accepted {int(vkeep.sum())}/{B}, median "
        f"surface distance {vmed:.6f}")
    if not (vkeep.sum() > 0.5 * B and vmed < 0.003):
        fail("view path misses bench.py's bar (accepted > 50%, median "
             "< 0.003)")
    if not bool(torch.isfinite(vres.batch.center[vres.batch.valid]).all()):
        fail("view path: non-finite centres among accepted patches")
    vround_ms, vround_host, vround_mem, vout = timed_rounds(view_round, reps)
    log(f"view path timed: {vround_ms:.2f} ms per round (CUDA events, mean "
        f"of {reps} after warm-up), {B / (vround_ms / 1e3):.1f} refined "
        f"patches/s; host clock {vround_host:.2f} ms per round; peak device "
        f"memory {vround_mem:.3f} GiB; accepted "
        f"{int(vout.batch.valid.sum())}/{B} | flat round {round_ms:.2f} ms "
        f"(host {round_host:.2f} ms, peak {round_mem:.3f} GiB)")

    # 11. the real-photo gate through the view path
    rv = refine_sharded(rscene.view_block(mesh.view.index, mesh.view.size),
                        rcfg, rpb, 0.01, True, 2, mesh.patch, mesh.view,
                        seed=3)
    rvkeep = rv.batch.valid.cpu().numpy()
    rvd = rsc.surface_distance(rv.batch.center.cpu().numpy()[rvkeep])
    rvmed = float(np.median(rvd)) if rvkeep.any() else float("inf")
    log(f"realistic gate, view path: {int(rvkeep.sum())}/{Br} seeds, "
        f"median surface distance {rvmed:.6f}")
    if not (rvkeep.sum() > 0.4 * Br and rvmed < 2.5e-3):
        fail("real-photo gate missed on the view path (accepted > 40%, "
             "median < 2.5e-3)")

    # 12. vp=5 on the one card: 5 gloo ranks, one camera each, B=64
    sub5, ref5, lod5, ray5, pos5 = selftest_inputs(scene, cfg, pb, Bs, 16, 9)
    flat5 = CF.patch_fitness(scene, cfg, ref5, sub5.cam_mask, lod5, ray5,
                             pos5)
    v1 = refine_sharded(block, cfg, small, 0.005, True, 1, mesh.patch,
                        mesh.view,
                        draws=[type(draws)(*(t.to(dev) for t in draws))])
    t0 = time.time()
    outs = run_vp_workers(5, dict(
        cfg=cfg, params=sc.params, images=sc.images,
        fit_in=[t.cpu().numpy() for t in (ref5, sub5.cam_mask, lod5, ray5,
                                          pos5)],
        pb=small.numpy(), draws=tuple(t.numpy() for t in draws)))
    for k in ("fit", "valid", "center"):
        if not all(np.array_equal(o[k], outs[0][k]) for o in outs[1:]):
            fail(f"vp=5: the ranks returned different {k}")
    if any(int(o["images"][0]) != 1 for o in outs):
        fail("vp=5: a rank holds more than its one camera")
    compare_fitness("vp=5 view fitness vs flat K1",
                    torch.as_tensor(outs[0]["fit"], device=dev), flat5)
    v1v = v1.batch.valid.cpu().numpy()
    v5v = outs[0]["valid"]
    bv = v1v & v5v
    dc5 = np.linalg.norm(outs[0]["center"][bv]
                         - v1.batch.center.cpu().numpy()[bv], axis=-1)
    agree5 = float((v1v == v5v).mean())
    mdc5 = float(np.median(dc5)) if bv.any() else float("inf")
    log(f"vp=5 vs vp=1 refine (B={Bs}, same draws, {time.time() - t0:.1f} "
        f"s for 5 ranks): valid agreement {agree5:.3f}, accepted "
        f"{int(v5v.sum())} vs {int(v1v.sum())}, median centre difference "
        f"{mdc5:.3g}")
    if agree5 < 0.95 or mdc5 > 1e-4:
        fail("vp=5 refine disagrees with vp=1")

    # 13. M: the microbench tool (its launches), then each variant against
    #     the plain twin, and their times in turns beside grid_sample
    CF.reset_launch_counts()
    if MB.main(["--reps", "20"]) != 0:
        fail("the microbench tool failed")
    mb_launches = dict(CF.LAUNCHES)
    box = MB.make_box(0)
    mb_plain = MB.run_grid_plain(box)
    mb_err = {}
    for v in MB.VARIANTS:
        got = MB.run_grid(box, variant=v)
        rel = MB.max_rel_err(got, mb_plain)
        if not rel <= 1e-4:
            fail(f"M({v}): relative error {rel:.3g} over 1e-4")
        mb_err[v] = float((got - mb_plain).abs().max())
        log(f"M({v}) against the plain twin: max |err| {mb_err[v]:.3g}, "
            f"relative {rel:.3g}")
    #    in turns; "d1" is (d) on a grid of one cell per block (its ring
    #    never prefetches): against (c) it costs the ring's per-cell work,
    #    against (d) the persistent grid's uneven last cells
    mb_runs = {v: dict(variant=v) for v in MB.VARIANTS}
    mb_runs["d1"] = dict(variant="d", grid=MB.CELLS)
    mb_dev = {v: [] for v in mb_runs}
    mb_host = {v: [] for v in mb_runs}
    for _ in range(5):
        for v in list(mb_runs) + list(mb_runs)[::-1]:
            d_ms, h_ms = time_ms(lambda: MB.run_grid(box, **mb_runs[v]),
                                 reps=50)
            mb_dev[v].append(d_ms)
            mb_host[v].append(h_ms)
    mb = {v: (*median_iqr(mb_dev[v]), float(np.median(mb_host[v])))
          for v in mb_runs}
    mb_plain_ms = wall_ms(lambda: MB.run_grid_plain(box), reps=3)
    mb_bound, mb_by = MB.bound_ms()
    mb_lib_ms, mb_lib_host = time_ms(microbench_library(box), reps=10)
    mb_use = ptxas_usage(logs.get("microbench", ""))
    mb_grid = MB.persistent_grid(MB.tap_footprint(), box.device.index)
    mb_sass = MB.sass_per_step()
    mb_regs = {}
    for v in MB.VARIANTS:
        use = [u for fn, u in mb_use.items() if f"microbench_{v}_kernel" in fn]
        mb_regs[v] = use[0] if use else {}
        log(f"M({v}) {MB.LABELS[v]}: {mb[v][0]:.4f} ms (IQR {mb[v][1]:.4f}, "
            f"ten times in turns), host {mb[v][2]:.4f} ms; ptxas "
            f"{mb_regs[v] or 'not reported (cached build)'}, dynamic shared "
            f"memory {MB.smem_bytes(v)} B; tap loop {mb_sass[v][0]:.2f} SASS "
            f"instructions per (pixel, particle) step: " + ", ".join(
                f"{op} {n:.2f}" for op, n in sorted(
                    mb_sass[v][1].items(), key=lambda x: -x[1])))
    log(f"M(d) on a grid of one cell per block: {mb['d1'][0]:.4f} ms (IQR "
        f"{mb['d1'][1]:.4f}), against (c) {mb['c'][0]:.4f} and (d) "
        f"{mb['d'][0]:.4f} ms on {mb_grid} blocks")
    log(f"M at {MB.CELLS} cells: plain {mb_plain_ms:.3f} ms, bound "
        f"{mb_bound:.4f} ms ({mb_by}), grid_sample (sampling only, not the "
        f"same function) {mb_lib_ms:.4f} ms (host {mb_lib_host:.4f}); (d)'s "
        f"grid {mb_grid} blocks; footprint {MB.tap_footprint()}; tool "
        f"launches {mb_launches}")

    # 14. kernel times at the main path's shapes
    #    K1: the first PSO evaluation of the round (particles drawn in the
    #    PSO bounds, every live swarm active); the atlas stays in L2 across
    #    the PSO loop, as it does here across repeated launches
    ref, lod, ray, valid, pos = first_evaluation(scene, cfg, pb, P, gen)
    err_main, (H, pt, pvalid) = check_fitness(
        f"main shape B={B} P={P}", scene, cfg, ref, pb.cam_mask, lod, ray,
        pos, valid)
    err1 = max(err1, err_main)
    k1 = (scene.pyramids, cfg, H, pt, ref, pb.cam_mask, lod, pvalid, valid)
    k1_ms, k1_host = time_ms(lambda: CF.score_windows(*k1), reps=20)
    k1_plain = wall_ms(lambda: F.score_windows(*k1), reps=3)
    k1_bound, k1_by, k1_what = k1_bound_ms(scene, *k1[1:])
    log(f"K1 at B={B} P={P} r={cfg.patch_radius}, first evaluation: "
        f"{k1_ms:.4f} ms/launch on the device, {k1_host:.4f} ms host per "
        f"call, plain {k1_plain:.3f} ms, bound {k1_bound:.4f} ms ({k1_by}: "
        f"{k1_what})")
    #    K1 on the inputs of the round's 31st evaluation (phase 5)
    k1l = in_loop[30]
    err1 = max(err1, compare_fitness(
        "K1 in-loop (evaluation 31 of 61) vs plain", CF.score_windows(*k1l),
        torch.where(k1l[-1][:, None], F.score_windows(*k1l), 1e30)))
    k1l_ms, k1l_host = time_ms(lambda: CF.score_windows(*k1l), reps=20)
    k1l_bound, k1l_by, k1l_what = k1_bound_ms(scene, *k1l[1:])
    log(f"K1 in-loop: {k1l_ms:.4f} ms/launch on the device, {k1l_host:.4f} "
        f"ms host per call, bound {k1l_bound:.4f} ms ({k1l_by}: {k1l_what}); "
        f"x61 per round = {61 * k1_ms:.2f} (first) to {61 * k1l_ms:.2f} "
        f"(in-loop) ms of the {round_ms:.2f} ms round")
    C = scene.num_cameras
    W2 = (2 * cfg.patch_radius + 1) ** 2
    atlas = scene.pyramids.images
    Ha, Wa = atlas.shape[1:]

    #    K2: the round's NCC pruning call, on the round's output patches
    ob = res.batch
    err_main2, (H2, pt2) = check_sampler(
        f"main shape B={B}", scene, cfg, ob.center, ob.normal(), ob.ref_cam,
        ob.cam_mask, ob.lod)
    err2 = max(err2, err_main2)
    r = cfg.patch_radius
    k2 = (scene.pyramids, H2, pt2, ob.lod, ob.cam_mask, r)
    k2_ms, k2_host = time_ms(lambda: CF.warped_samples(*k2), reps=50)
    k2_plain = wall_ms(lambda: F.warped_samples(*k2), reps=5)
    k2_ops = float(int(ob.cam_mask.sum()) * W2 * K2_OPS_SAMPLE)
    #    bytes: the distinct atlas elements the in-margin taps read, the
    #    small inputs whole, the [B, C, W2] f32 output written once
    n_k2 = int(touched_atlas_elements(
        scene.pyramids, H2, pt2, ob.lod, ob.cam_mask,
        torch.ones(B, dtype=torch.bool, device=dev), r, 0.0, 1.0).sum())
    k2_bytes = float(n_k2 * atlas.element_size() + H2.numel() * 4
                     + pt2.numel() * 4 + B * 4 + ob.cam_mask.numel()
                     + B * C * W2 * 4)
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / FP32_OPS_PER_S) * 1e3
    k2_by = ("bytes" if k2_bytes / HBM_BYTES_PER_S
             >= k2_ops / FP32_OPS_PER_S else "operations")
    #    library yardstick: grid_sample on the same coordinates (the atlas
    #    as [C, 1, Ha, Wa] f32, one grid row per camera)
    import torch.nn.functional as TNF
    offs = torch.as_tensor(F.window_offsets(r), device=dev)
    win = pt2[:, None, :] + offs                               # [B, W2, 2]
    x, y = win[..., 0][..., None], win[..., 1][..., None]
    Hc = H2[:, None]                                           # [B,1,C,3,3]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = torch.where(w == 0, 1.0, w)
    uu = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    vv = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    vv = vv + scene.pyramids.yoff[ob.lod.long()].float()[:, None, None]
    grid = torch.stack([uu / (Wa - 1) * 2 - 1, vv / (Ha - 1) * 2 - 1],
                       -1).permute(2, 0, 1, 3).contiguous()   # [C,B,W2,2]
    img = atlas.float()[:, None]
    lib_ms, lib_host = time_ms(lambda: TNF.grid_sample(
        img, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), reps=50)
    log(f"K2 at B={B} r={r}: {k2_ms:.4f} ms/launch on the device, "
        f"{k2_host:.4f} ms host per call, plain {k2_plain:.3f} ms, "
        f"grid_sample {lib_ms:.4f} ms (host {lib_host:.4f}), bound {k2_bound:.4f} ms ({k2_by}: "
        f"{k2_bytes:.3e} bytes of which atlas {n_k2} elements of "
        f"{atlas.numel()}, {k2_ops:.3e} FP32 ops)")
    del grid, uu, vv, w, sw

    #    the view kernels: the round's first view-path evaluation, on K1's
    #    inputs above (act = live swarms x visible cameras; vp=1, so every
    #    row is owned; the edge plane only if the workload weighs
    #    gradients, as the view path does), then on the inputs of the
    #    round's 31st evaluation (phase 10)
    grad = cfg.adaptive_gradient_enable
    vpyrs = VF._local_pyramids(scene.pyramids, 0, C)
    act = (valid[:, None] & pb.cam_mask).contiguous()
    own = torch.ones(B, dtype=torch.bool, device=dev)
    cn = pb.cam_mask.sum(-1).float()
    vargs = (vpyrs, H, pt, lod, act, pb.cam_mask, pvalid, ref, own, cn)
    ea, eb = check_view_kernels(f"main shape B={B} P={P}", vargs, r, grad)
    errva, errvb = max(errva, ea), max(errvb, eb)
    am = vargs[:9] + (r, grad)
    ad = (vpyrs, H, pt, lod, act, pvalid,
          CF.view_moments(*am)[0] / cn[:, None, None], r)
    va_ms, va_host = time_ms(lambda: CF.view_moments(*am), reps=20)
    vb_ms, vb_host = time_ms(lambda: CF.view_deviation(*ad), reps=20)
    va_plain = wall_ms(lambda: F.view_moments(*am), reps=3)
    vb_plain = wall_ms(lambda: F.view_deviation(*ad), reps=3)
    (va_bound, va_by, va_what), (vb_bound, vb_by, vb_what) = view_bound_ms(
        vargs, r, grad, ref_pixels(vpyrs, pt, ref, own, lod, r))
    aml, adl = view_in["view_moments"][30], view_in["view_deviation"][30]
    ea, eb = check_view_kernels("in-loop (evaluation 31 of 61)",
                                aml[:9] + (aml[5].sum(-1).float(),), r, grad)
    errva, errvb = max(errva, ea), max(errvb, eb)
    dl_p, dl_k = F.view_deviation(*adl), CF.view_deviation(*adl)
    if not bool((dl_k - dl_p).abs().le(
            1e-5 * dl_p.abs().clamp(min=1.0)).all()):
        fail("view_deviation in-loop on the round's own mean: over 1e-5")
    val_ms, val_host = time_ms(lambda: CF.view_moments(*aml), reps=20)
    vbl_ms, vbl_host = time_ms(lambda: CF.view_deviation(*adl), reps=20)
    (val_bound, _, val_what), (vbl_bound, _, vbl_what) = view_bound_ms(
        aml[:9], r, grad, ref_pixels(vpyrs, aml[2], aml[7], aml[8], aml[3],
                                     r))
    for name, ms, host, plain, bound, by, what, ms_l, host_l, bound_l, \
            what_l in (("view_moments (A)", va_ms, va_host, va_plain,
                        va_bound, va_by, va_what, val_ms, val_host,
                        val_bound, val_what),
                       ("view_deviation (B)", vb_ms, vb_host, vb_plain,
                        vb_bound, vb_by, vb_what, vbl_ms, vbl_host,
                        vbl_bound, vbl_what)):
        log(f"{name} at B={B} P={P} r={r}: first evaluation {ms:.4f} "
            f"ms/launch on the device, {host:.4f} ms host per call, plain "
            f"{plain:.3f} ms, bound {bound:.4f} ms ({by}: {what}); in-loop "
            f"{ms_l:.4f} ms (host {host_l:.4f}), bound {bound_l:.4f} ms "
            f"({what_l}); x61 per view round = {61 * ms:.2f} (first) to "
            f"{61 * ms_l:.2f} (in-loop) ms of the {vround_ms:.2f} ms round")
    #    library yardstick, sampling only: grid_sample on the first
    #    evaluation's coordinates, one grid row per particle (the kernels
    #    also sum over the cameras and read the reference windows)
    offs = torch.as_tensor(F.window_offsets(r), device=dev)
    win = pt[:, :, None, :] + offs                             # [B,P,W2,2]
    x, y = win[..., 0][..., None], win[..., 1][..., None]
    Hc = H[:, :, None]                                         # [B,P,1,C,3,3]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = torch.where(w == 0, 1.0, w)
    uu = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    vv = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    vv = vv + scene.pyramids.yoff[lod.long()].float()[:, None, None, None]
    grid = torch.stack([uu / (Wa - 1) * 2 - 1, vv / (Ha - 1) * 2 - 1],
                       -1).permute(3, 0, 1, 2, 4).reshape(
                           C, B * P, W2, 2).contiguous()       # [C,BP,W2,2]
    del win, x, y, Hc, w, sw, uu, vv
    img = atlas.float()[:, None]
    lib_v_ms, lib_v_host = time_ms(lambda: TNF.grid_sample(
        img, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), reps=20)
    log(f"grid_sample (sampling only) on the view evaluation's coordinates: "
        f"{lib_v_ms:.4f} ms on the device (host {lib_v_host:.4f})")
    del grid, img
    #    one whole fitness_view evaluation (both kernels, both psums through
    #    the NCCL group of world 1, the torch weights), device time: the
    #    like-for-like yardstick now that the kernels absorb the epilogue
    #    (4 calls: some 170 launches each must fit the launch queue)
    evaluate = lambda: VF.fitness_view(block, cfg, ref, pb.cam_mask, lod,
                                       ray, pos, mesh.view, active=valid)
    compare_fitness("view fitness at the main shape vs K1", evaluate(),
                    CF.score_windows(*k1))
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    ev_ms, ev_host = time_ms(evaluate, reps=4)
    ev_mem = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    log(f"one fitness_view evaluation at B={B} P={P} r={r} (first of the "
        f"round): {ev_ms:.4f} ms on the device, {ev_host:.4f} ms host per "
        f"call, {ev_mem:.3f} GiB of device memory above its inputs; x61 = "
        f"{61 * ev_ms:.2f} ms of the {vround_ms:.2f} ms view round")
    torch.distributed.destroy_process_group()
    torch.cuda.synchronize()

    # 15. the expansion-mode refine (narrowed normal bounds, P and T not
    #     doubled) on the card vs on the CPU (plain twins), same draws, on
    #     phase 6's parents; then the launches of one full-width expansion
    #     chunk at bench.py's shape
    Pe, Te = cfg.particle_num, cfg.max_iteration
    edraws = draw_uniforms(Bs, Pe, 3, Te,
                           generator=torch.Generator().manual_seed(6),
                           device="cpu")
    g = lc.refine_batch(scene, cfg, small, 0.005, False, 1,
                        draws=[type(edraws)(*(t.to(dev) for t in edraws))])
    c = lc.refine_batch(scene.to("cpu"), cfg, small.to("cpu"), 0.005, False,
                        1, draws=[edraws])
    gv, cv = g.batch.valid.cpu().numpy(), c.batch.valid.numpy()
    bv = gv & cv
    dc = np.linalg.norm(g.batch.center.cpu().numpy()[bv]
                        - c.batch.center.numpy()[bv], axis=-1)
    eagree = float((gv == cv).mean())
    emdc = float(np.median(dc)) if bv.any() else float("inf")
    log(f"expansion-mode refine, card vs CPU (B={Bs}, P={Pe}, T={Te}, same "
        f"draws): valid agreement {eagree:.3f}, accepted {int(gv.sum())} vs "
        f"{int(cv.sum())}, median centre difference {emdc:.3g}")
    if (eagree < 0.95 or abs(int(gv.sum()) - int(cv.sum())) > 2
            or emdc > 1e-4 or bv.sum() < 0.5 * Bs):
        fail("the card's expansion-mode refine disagrees with the CPU "
             "reference")
    torch.cuda.synchronize()
    CF.reset_launch_counts()
    t0 = time.time()
    eres = lc.refine_batch(scene, cfg, pb, 0.005, False, 1, generator=gen)
    torch.cuda.synchronize()
    echunk_first_s = time.time() - t0
    elaunches = dict(CF.LAUNCHES)
    if elaunches != {**dict.fromkeys(CF.LAUNCHES, 0), "fitness": 1 + Te,
                     "sampler": 1}:
        fail(f"expansion chunk launch counts {elaunches}, expected fitness "
             f"{1 + Te} (1 + {Te} PSO evaluations), sampler 1 and no other")
    if not bool(torch.isfinite(eres.batch.center[eres.batch.valid]).all()):
        fail("expansion chunk: non-finite centres among accepted patches")
    echunk_ms, echunk_host, echunk_mem, _ = timed_rounds(
        lambda: lc.refine_batch(scene, cfg, pb, 0.005, False, 1,
                                generator=gen), reps)
    log(f"expansion chunk at bench.py's shape (B={B}, P={Pe}, T={Te}): "
        f"launches {elaunches}; first run {echunk_first_s:.2f} s, then "
        f"{echunk_ms:.2f} ms per chunk (CUDA events, mean of {reps}), host "
        f"clock {echunk_host:.2f} ms, peak device memory {echunk_mem:.3f} "
        f"GiB; accepted {int(eres.batch.valid.sum())}/{B}")

    # 16. -r through the port's CLI, in this process, on the pawn rig's
    #     real photograph at 1280x960 (5 cameras, 300 seeds)
    t0 = time.time()
    rsc2 = make_realistic_scene(num_seeds=300, seed=0, scale=2)
    n_seeds = len(rsc2.seed_centers)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    nvm = write_scene_files(work, rsc2, REAL_CONFIG_TXT)
    log(f"real-photo scene at 2x: {rsc2.images[0].shape[1]}x"
        f"{rsc2.images[0].shape[0]}, {len(rsc2.params)} cameras, {n_seeds} "
        f"seeds, written as PNG + NVM in {time.time() - t0:.1f} s")
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    CF.reset_launch_counts()
    t0 = time.time()
    rc, r_out = run_cli(["-r", nvm, "-o", work], work)
    torch.cuda.synchronize()
    r_s = time.time() - t0
    r_launches = dict(CF.LAUNCHES)
    r_mem = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    missing = [a for a in R_ARTIFACTS
               if not os.path.exists(os.path.join(work, a))]
    if rc != 0 or missing:
        fail(f"-r: exit code {rc}, artifacts missing {missing}")
    with open(os.path.join(work, "stats.json")) as f:
        st = json.load(f)
    exp = mvsbin.read_mvs(os.path.join(work, "exp.mvs")).patches
    n_acc, n_exp = st["seed_accepted"], len(exp.centers)
    exp_med = float(np.median(rsc2.surface_distance(exp.centers)))
    rounds_run = sum(1 for line in r_out if line.startswith("round "))
    log(f"-r (CLI, in process): {r_s:.1f} s; seeds {n_acc}/{n_seeds} "
        f"accepted in {st['seed_refine_s']:.2f} s; expansion {n_exp} "
        f"patches ({n_exp / max(n_acc, 1):.1f}x the seeds) in "
        f"{st['expansion_s']:.2f} s over {rounds_run} rounds, "
        f"{st['expansion_refined']} refined, {st['expansion_pps']:.1f} "
        f"refines/s; the refines' launch-to-completion spans (CUDA events, "
        f"expansion_device_s) {st['expansion_device_s']:.3f} s = "
        f"{st['expansion_device_s'] / max(st['expansion_s'], 1e-9):.3f} of "
        f"the expansion; median surface distance {exp_med:.6f}; peak "
        f"device memory {r_mem:.3f} GiB above the script's "
        f"{base_mem / 2 ** 30:.3f}; launches {r_launches}")
    path_launch_gate("-r", r_launches)
    if (n_acc, n_exp, f"{exp_med:.6f}") != R_CLOUD:
        fail(f"-r: {n_acc} seeds, {n_exp} patches, median {exp_med!r}: "
             f"the recorded cloud is {R_CLOUD}")
    if not n_acc > 0.4 * n_seeds:
        fail(f"-r: {n_acc}/{n_seeds} seeds accepted (gate > 40%)")
    if not n_exp >= 20 * n_acc:
        fail(f"-r: the cloud grew to {n_exp} from {n_acc} seeds (gate: "
             f"20x)")
    if not exp_med < 2.5e-3:
        fail(f"-r: median surface distance {exp_med:.6f} (gate < 2.5e-3)")
    if st["live_patches"] != n_exp or not np.isfinite(exp.centers).all():
        fail(f"-r: exp.mvs holds {n_exp} patches, stats.json "
             f"{st['live_patches']} live (or non-finite centres)")
    if not st["expansion_device_s"] <= st["expansion_s"]:
        fail("-r: expansion_device_s exceeds expansion_s")

    #     K1 and K2 against their twins at this path's shapes
    rec = cli_reconstructor(nvm, work, dev)
    more = make_realistic_scene(num_seeds=B, seed=0, scale=2)
    if not all(np.array_equal(a, b) for a, b in zip(more.images,
                                                    rsc2.images)):
        fail(f"the {B}-seed render's images differ from the CLI's files")
    err1_r, err2_r = check_r_shapes(rec, (more.seed_centers,
                                          more.seed_cam_masks,
                                          more.seed_img_points), gen)
    del more
    err1, err2 = max(err1, err1_r), max(err2, err2_r)

    #     the expansion's device-busy share: the same seeds and expansion
    #     once more, under the profiler (CUDA activity only)
    from torch.profiler import ProfilerActivity, profile
    prof_dir = os.path.join(work, "profiled")
    rec.refine_seeds()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_prof = rec.expand(autosave_path=os.path.join(prof_dir,
                                                       "auto_save.mvs"))
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    busy_s, n_act = device_busy_s(prof)
    del prof
    log(f"-r expansion under the profiler: {n_prof} patches (the CLI run: "
        f"{n_exp}) in {p_wall:.3f} s (unprofiled {st['expansion_s']:.3f} "
        f"s); device busy {busy_s:.3f} s over {n_act} device activities = "
        f"busy share {busy_s / p_wall:.3f}, idle share "
        f"{1 - busy_s / p_wall:.3f}; the refines' launch-to-completion "
        f"spans {rec.stats['expansion_device_s']:.3f} s; trace read in "
        f"{time.perf_counter() - t0:.1f} s")
    if not 0 < busy_s <= p_wall:
        fail(f"-r expansion: device busy {busy_s:.3f} s outside (0, "
             f"{p_wall:.3f}] s")
    del rec

    # 17. -f on phase 16's exp.mvs
    t0 = time.time()
    rc, f_out = run_cli(["-f", os.path.join(work, "exp.mvs"), "-o", work],
                        work)
    f_s = time.time() - t0
    missing = [a for a in F_ARTIFACTS
               if not os.path.exists(os.path.join(work, a))]
    if rc != 0 or missing:
        fail(f"-f: exit code {rc}, artifacts missing {missing}")
    removed = removal_counts(f_out)
    f3 = mvsbin.read_mvs(os.path.join(work, "PMVS_filter3.mvs")).patches
    pc = mvsbin.read_mvs(os.path.join(work, "PCMVS_filter.mvs")).patches
    f3_med = float(np.median(rsc2.surface_distance(f3.centers)))
    avg_nb = [line for line in f_out if "avg neighbours" in line]
    log(f"-f (CLI, in process): {f_s:.1f} s; removed {removed}; "
        f"{len(f3.centers)} patches after the three structural filters, "
        f"median {f3_med:.6f} (expansion {exp_med:.6f}); "
        f"neighborPatchFiltering leaves {len(pc.centers)} "
        f"({avg_nb[0] if avg_nb else 'no avg neighbours line'})")
    if not (f3_med <= exp_med and f3_med < 2.5e-3 and len(f3.centers)):
        fail(f"-f: PMVS_filter3 median {f3_med:.6f} against the expansion's "
             f"{exp_med:.6f} (gate: no worse, < 2.5e-3)")

    # 18. feature seeding at full width on the pawn rig at 2x: twice on the
    #     card (bit-equal), once on the CPU (same seeds), then -r on an NVM
    #     without points through the CLI
    from pais_mvs_tpu_torch.features import generate_seed_patches
    from pais_mvs_tpu_torch.io import nvm as nvm_io
    fcfg = MvsConfig(min_cam_num=3)
    feats, feat_s = [], []
    for where in (dev, dev, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats.append(generate_seed_patches(rsc2.params, rsc2.images, fcfg,
                                           max_epipolar_dist=3.0,
                                           device=where))
        torch.cuda.synchronize()
        feat_s.append(time.perf_counter() - t0)
    (fc, fm, fi, fcol), again, cpu = feats
    n_feat = len(fc)
    feat_med = float(np.median(rsc2.surface_distance(fc)))
    det_ms, match_ms = feature_stage_ms(rsc2.images, dev)
    views = np.bincount(fm.sum(1), minlength=len(rsc2.params) + 1)[3:]
    log(f"feature seeding on the card: {n_feat} seeds (JAX CPU record "
        f"{JAX_FEATURE_SEEDS}), median surface distance {feat_med:.6g} "
        f"(record {JAX_FEATURE_MEDIAN:g}), seen in 3/4/5 views "
        f"{'/'.join(map(str, views))}; {feat_s[0]:.3f} s first run, "
        f"{feat_s[1]:.3f} s second (detection + description "
        f"{det_ms:.1f} ms, matching {match_ms:.1f} ms), CPU "
        f"{feat_s[2]:.2f} s")
    if not all(np.array_equal(a, b) for a, b in zip(feats[0], again)):
        fail("feature seeding: two card runs differ")
    cdiff = (float(np.abs(fc - cpu[0]).max()) if len(cpu[0]) == n_feat
             else float("inf"))
    if len(cpu[0]) != n_feat or not np.array_equal(fm, cpu[1]) or \
            cdiff > 1e-4:
        fail(f"feature seeding: card {n_feat} seeds vs CPU {len(cpu[0])}, "
             f"max centre difference {cdiff:.3g} (gate: same seeds and "
             f"camera sets, 1e-4)")
    log(f"feature seeding card vs CPU: same {n_feat} seeds and camera sets, "
        f"max centre difference {cdiff:.3g}; the two card runs bit-equal")
    if not (abs(n_feat - JAX_FEATURE_SEEDS) <= 0.05 * JAX_FEATURE_SEEDS
            and feat_med < 1e-3):
        fail(f"feature seeding: {n_feat} seeds at median {feat_med:.6g} "
             f"(gate: within 5% of {JAX_FEATURE_SEEDS}, median < 1e-3)")
    nopts = os.path.join(work, "nopts.nvm")
    nvm_io.save_nvm(nopts, nvm_io.load_nvm(nvm).cameras)
    feat_runs = []
    for k in range(2):
        out_k = os.path.join(work, f"features_r{k}")
        os.makedirs(out_k)
        CF.reset_launch_counts()
        t0 = time.time()
        rc, fr_out = run_cli(["-r", nopts, "-o", out_k], work)
        torch.cuda.synchronize()
        feat_runs.append((time.time() - t0, dict(CF.LAUNCHES), out_k))
        if rc != 0:
            fail(f"-r nopts.nvm: exit code {rc}")
    fr_s, fr_launches, fdir = feat_runs[0]
    # determinism of -r on the card, feature-seeded or not: the two runs
    # above, and phase 16's -r once more
    again = os.path.join(work, "r_again")
    os.makedirs(again)
    t0 = time.time()
    rc, _ = run_cli(["-r", nvm, "-o", again], work)
    again_s = time.time() - t0
    for a, b, what in ((fdir, feat_runs[1][2], "-r nopts.nvm"),
                       (work, again, "-r scene.nvm (phase 16)")):
        with open(os.path.join(a, "exp.mvs"), "rb") as f1, \
                open(os.path.join(b, "exp.mvs"), "rb") as f2:
            if rc != 0 or f1.read() != f2.read():
                fail(f"{what}: two runs on the card wrote different "
                     f"exp.mvs bytes (exit code {rc})")
    log(f"-r determinism on the card: phase 16's -r again in "
        f"{again_s:.1f} s, exp.mvs bit-equal; the feature-seeded pair "
        f"bit-equal")
    with open(os.path.join(fdir, "stats.json")) as f:
        fst = json.load(f)
    fexp = mvsbin.read_mvs(os.path.join(fdir, "exp.mvs")).patches
    n_fs = int([ln for ln in fr_out if "feature seeding:" in ln][0]
               .split("feature seeding:")[1].split()[0])
    f_acc, f_n = fst["seed_accepted"], len(fexp.centers)
    f_med = float(np.median(rsc2.surface_distance(fexp.centers)))
    log(f"-r nopts.nvm (CLI, feature-seeded): {fr_s:.1f} s (second run "
        f"{feat_runs[1][0]:.1f} s, exp.mvs bit-equal); {n_fs} seeds, "
        f"{f_acc} accepted; the cloud {f_n} patches "
        f"({f_n / max(f_acc, 1):.1f}x), median {f_med:.6f}; expansion "
        f"{fst['expansion_s']:.2f} s; feature seeding "
        f"{feat_s[1]:.3f} s = {feat_s[1] / fr_s:.3f} of the run (JAX CPU "
        f"record: 283/363 accepted, 11,029 patches, median 1.520e-3); "
        f"launches {fr_launches}")
    missing = [a for a in R_ARTIFACTS
               if not os.path.exists(os.path.join(fdir, a))]
    if missing or n_fs != n_feat:
        fail(f"-r nopts.nvm: artifacts missing {missing}, {n_fs} seeds "
             f"(generate_seed_patches: {n_feat})")
    path_launch_gate("-r nopts.nvm", fr_launches)
    if not (f_acc > 0.4 * n_fs and f_n >= 20 * f_acc and f_med < 2.5e-3
            and fst["live_patches"] == f_n):
        fail(f"-r nopts.nvm: {f_acc}/{n_fs} accepted, {f_n} patches, "
             f"median {f_med:.6f} (phase 16's gates)")

    # 19. bundle adjustment: the rig's 300 tracks with cameras 1-4
    #     perturbed, on the card and on the CPU; sharded through an NCCL
    #     world of 1; then -r -b through the CLI
    from pais_mvs_tpu_torch.ops.bundle import (BaProblem, bundle_adjust,
                                               bundle_adjust_sharded)
    ba_fields, R_true, c_true = ba_problem(rsc2)
    on = lambda where: BaProblem(*(torch.as_tensor(f, device=where)
                                   for f in ba_fields))
    ba_card = bundle_adjust(on(dev), num_iters=8)
    ba_cpu = bundle_adjust(on("cpu"), num_iters=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        bundle_adjust(on(dev), num_iters=8)
    torch.cuda.synchronize()
    t8 = (time.perf_counter() - t0) / 3
    t0 = time.perf_counter()
    for _ in range(3):
        bundle_adjust(on(dev), num_iters=0)
    torch.cuda.synchronize()
    ba_ms_it = (t8 - (time.perf_counter() - t0) / 3) / 8 * 1e3
    h_card = ba_card.rms_history.cpu().numpy()
    h_cpu = ba_cpu.rms_history.numpy()
    c_card = ba_card.center.cpu().numpy()
    dR = float(np.abs(ba_card.R.cpu().numpy() - ba_cpu.R.numpy()).max())
    dC = float(np.abs(scale_aligned(c_card, ba_cpu.center.numpy())
                      - ba_cpu.center.numpy()).max())
    log(f"bundle adjustment on the card ({len(ba_fields[4])} tracks, 5 "
        f"cameras, 8 LM iterations): RMS history {h_card.tolist()} px; "
        f"the CPU's {h_cpu.tolist()}; JAX CPU record 9.2866 -> 0.0949 -> "
        f"7.81e-5 -> ... -> 4.73e-5 px; {t8 * 1e3:.1f} ms per solve, "
        f"{ba_ms_it:.2f} ms per LM iteration (host clock, synchronised); "
        f"card vs CPU: R {dR:.3g}, scale-aligned centres {dC:.3g}; max "
        f"centre error {np.abs(ba_fields[1] - c_true).max():.4f} before, "
        f"{np.abs(c_card - c_true).max():.4f} after (gauge free up to "
        f"scale), scale-aligned "
        f"{np.abs(scale_aligned(c_card, c_true) - c_true).max():.3g}")
    if not (abs(h_card[0] - h_cpu[0]) <= 1e-5 * h_cpu[0]
            and h_card[-1] < 1e-3 and h_cpu[-1] < 1e-3
            and dR < 1e-4 and dC < 1e-4):
        fail("bundle adjustment: the card's solve misses the CPU's (start "
             "1e-5 relative, final RMS < 1e-3 px, R and scale-aligned "
             "centres 1e-4)")
    init_distributed(f"tcp://localhost:{free_port()}", 0, 1,
                     backend="nccl", device="cuda")
    ba_sh = bundle_adjust_sharded(on(dev), make_mesh((1, 1)).patch,
                                  num_iters=8)
    torch.distributed.destroy_process_group()
    if not all(torch.equal(a, b) for a, b in zip(ba_sh, ba_card)):
        fail("bundle_adjust_sharded (NCCL world of 1) differs from "
             "bundle_adjust")
    log("bundle_adjust_sharded through an NCCL world of 1: bit-equal to "
        "bundle_adjust")
    bdir = os.path.join(work, "refine_poses")
    os.makedirs(bdir)
    CF.reset_launch_counts()
    t0 = time.time()
    rc, b_out = run_cli(["-r", nvm, "-b", "-o", bdir], work)
    torch.cuda.synchronize()
    b_s = time.time() - t0
    b_launches = dict(CF.LAUNCHES)
    rms_line = [ln for ln in b_out if ln.startswith("pose refinement:")]
    with open(os.path.join(bdir, "stats.json")) as f:
        bst = json.load(f)
    bexp = mvsbin.read_mvs(os.path.join(bdir, "exp.mvs")).patches
    b_acc, b_n = bst["seed_accepted"], len(bexp.centers)
    b_med = float(np.median(rsc2.surface_distance(bexp.centers)))
    log(f"-r -b (CLI): {b_s:.1f} s; {rms_line}; {b_acc}/{n_seeds} seeds "
        f"accepted, the cloud {b_n} patches, median {b_med:.6f} (JAX CPU "
        f"record: 144/300, 11,268, 1.577e-3); launches {b_launches}")
    missing = [a for a in R_ARTIFACTS
               if not os.path.exists(os.path.join(bdir, a))]
    if rc != 0 or missing or len(rms_line) != 1:
        fail(f"-r -b: exit code {rc}, artifacts missing {missing}, RMS "
             f"lines {rms_line}")
    path_launch_gate("-r -b", b_launches)
    if not (b_acc > 0.4 * n_seeds and b_n >= 20 * b_acc and b_med < 2.5e-3
            and bst["live_patches"] == b_n):
        fail(f"-r -b: {b_acc}/{n_seeds} accepted, {b_n} patches, median "
             f"{b_med:.6f} (phase 16's gates)")

    # 20. -v exp.mvs --patch-id N --reoptimize --profile DIR on phase 16's
    #     output; warped_windows on the card against the CPU; K1 and K2
    #     against their twins at B = 1
    from pais_mvs_tpu_torch import cli
    from pais_mvs_tpu_torch import diagnostics as TD
    exp_path = os.path.join(work, "exp.mvs")
    pid = n_exp // 2
    vdir, pdir = os.path.join(work, "view"), os.path.join(work, "prof")
    os.makedirs(vdir)
    CF.reset_launch_counts()
    t0 = time.time()
    rc, v_out = run_cli(["-v", exp_path, "--patch-id", str(pid),
                         "--reoptimize", "--profile", pdir, "-o", vdir],
                        work)
    torch.cuda.synchronize()
    v_s = time.time() - t0
    v_launches = dict(CF.LAUNCHES)
    v_art = ["view_snapshot.ply", "view.html"] + [
        f"patch{i}_{k}.png" for i in (pid, pid * 1000000 + 1)
        for k in ("views", "error")]
    missing = [a for a in v_art if not os.path.exists(os.path.join(vdir, a))]
    reopt = [ln for ln in v_out if ln.startswith("re-optimized:")]
    if rc != 0 or missing or len(reopt) != 1 or \
            not os.path.exists(os.path.join(pdir, "trace.json")):
        fail(f"-v: exit code {rc}, artifacts missing {missing}, "
             f"re-optimized lines {reopt}, trace in {os.listdir(pdir)}")
    path_launch_gate("-v --reoptimize", v_launches)
    log(f"-v --patch-id {pid} --reoptimize --profile (CLI): {v_s:.1f} s; "
        f"{reopt[0]}; trace "
        f"{os.path.getsize(os.path.join(pdir, 'trace.json'))} bytes; "
        f"launches {v_launches}")
    here = os.getcwd()
    os.chdir(work)
    try:
        vrec = cli._build_reconstructor(exp_path, vdir, dev)
    finally:
        os.chdir(here)
    vs, vc = vrec.scene, vrec.cfg
    one = pm.take(vrec._seed_pb, [pid])
    h1 = one.numpy()
    wargs = (h1["center"][0], h1["normal_sph"][0], int(h1["ref_cam"][0]),
             h1["cam_mask"][0], int(h1["lod"][0]))
    vs_cpu = vs.to("cpu")
    worst = 0.0
    for shift in (0.0, 0.05):
        wa = (wargs[0] + np.float32(shift),) + wargs[1:]
        wg, okg = TD.warped_windows(vs, vc, *wa)
        wc, okc = TD.warped_windows(vs_cpu, vc, *wa)
        if not (np.array_equal(okg, okc)
                and np.array_equal(np.isnan(wg), np.isnan(wc))):
            fail(f"warped_windows shift={shift}: the card's NaN or valid "
                 f"set differs from the CPU's")
        fin = ~np.isnan(wg)
        d = np.abs(wg[fin] - wc[fin])
        worst = max(worst, float(d.max()) if d.size else 0.0)
        if d.size and float(d.max()) > WINDOW_TOL:
            fail(f"warped_windows shift={shift}: max |err| {d.max():.3g} "
                 f"(gate {WINDOW_TOL} of 255 intensity levels)")
        log(f"warped_windows shift={shift}: {int(fin.sum())}/{fin.size} "
            f"samples in frame on both, NaN set equal, max |err| "
            f"{float(d.max()) if d.size else 0.0:.3g}")
    err1_v = err2_v = 0.0
    sub, ref, lod, ray, pos = selftest_inputs(vs, vc, one, 1,
                                              2 * vc.particle_num, 11)
    err1_v = max(err1_v, check_fitness(
        f"B=1 (the -v --reoptimize shape) P={2 * vc.particle_num} around "
        f"patch {pid}", vs, vc, ref, sub.cam_mask, lod, ray, pos)[0])
    ref, lod, ray, act, pos = first_evaluation(vs, vc, one,
                                               2 * vc.particle_num, gen)
    err1_v = max(err1_v, check_fitness(
        "B=1 first seed-mode evaluation", vs, vc, ref, one.cam_mask, lod,
        ray, pos, act)[0])
    n1 = one.normal()
    ref = lc.set_reference_camera(vs, n1, one.cam_mask)
    lod = lc.set_lod(vs, vc, one.center, ref)
    for shift in (0.0, 0.002):
        err2_v = max(err2_v, check_sampler(
            f"B=1 shift={shift}", vs, vc, one.center + shift, n1, ref,
            one.cam_mask, lod)[0])
    err1, err2 = max(err1, err1_v), max(err2, err2_v)
    del vrec, vs, vs_cpu

    # 21. -a exp.mvs: the insertion-order replay PLY
    adir = os.path.join(work, "animate")
    os.makedirs(adir)
    rc, _ = run_cli(["-a", exp_path, "-o", adir], work)
    with open(os.path.join(adir, "animate.ply")) as f:
        lines = f.read().splitlines()
    body = lines[lines.index("end_header") + 1:] if rc == 0 else []
    order = np.array([float(ln.split()[-1]) for ln in body])
    n_a = len(body)
    if rc != 0 or n_a != st["live_patches"] or not np.allclose(
            order, np.arange(n_a) / max(n_a - 1, 1), atol=1e-6):
        fail(f"-a: exit code {rc}, {n_a} points for {st['live_patches']} "
             f"live patches, or the order is not 0..N-1")
    log(f"-a (CLI): animate.ply holds exp.mvs's {n_a} patches, order "
        f"{order[0]:g}..{order[-1]:g} in insertion order")
    # 22. -r --distributed-expansion through the CLI, in this process (an
    #     NCCL world of one), on phase 16's files
    tol = half_cell(rsc2, 12)
    d22 = os.path.join(work, "dist")
    os.makedirs(d22)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    CF.reset_launch_counts()
    t0 = time.time()
    rc, _ = run_cli(["-r", nvm, "--distributed-expansion", "-o", d22], work)
    torch.cuda.synchronize()
    d22_s = time.time() - t0
    d_launches = dict(CF.LAUNCHES)
    d_mem = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    if rc != 0:
        fail(f"-r --distributed-expansion: exit code {rc}")
    if torch.distributed.is_initialized():
        fail("-r --distributed-expansion left its world of one initialised")
    st22, c22, med22 = r_gates("-r --distributed-expansion", d22, rsc2,
                               n_seeds)
    path_launch_gate("-r --distributed-expansion", d_launches)
    ag22, ratio22 = agreement_gates("-r --distributed-expansion vs phase 16",
                                    c22, exp.centers, tol)
    if not 0 < st22["dist_device_s"] <= st22["dist_expansion_s"]:
        fail("-r --distributed-expansion: dist_device_s outside "
             "(0, dist_expansion_s]")
    log(f"-r --distributed-expansion (CLI, in process, NCCL world of 1): "
        f"{d22_s:.1f} s; seeds {st22['seed_accepted']}/{n_seeds}; "
        f"expansion {len(c22)} patches in {st22['dist_expansion_s']:.2f} s "
        f"over {st22['dist_rounds']} rounds, {st22['dist_refined']} "
        f"refined ({st22['dist_pps']:.1f} refines/s), {st22['dist_spilled']} "
        f"spilled; the steps' launch-to-completion spans (CUDA events, "
        f"dist_device_s) {st22['dist_device_s']:.3f} s; median "
        f"{med22:.6f}; against phase 16's {len(exp.centers)} patches: "
        f"agreement {ag22[0]:.3f} / {ag22[1]:.3f} at half a cell "
        f"({tol:.3g}), count ratio {ratio22:.3f}; peak device memory "
        f"{d_mem:.3f} GiB above the script's {base_mem / 2 ** 30:.3f}; "
        f"launches {d_launches}")

    # 23. dp=4: four CLI processes joined by --coordinator (gloo, card 0)
    port = free_port()
    dirs = [os.path.join(work, f"dp4_{i}") for i in range(4)]
    env = {**os.environ, "PYTHONPATH": HERE}
    for d in dirs:
        os.makedirs(d)
    t0 = time.time()
    run_children("dp=4 CLI processes", [
        [sys.executable, "-m", "pais_mvs_tpu_torch.cli", "-r", nvm,
         "--distributed-expansion", "--mesh-shape", "4,1", "--coordinator",
         f"localhost:{port}", "--num-processes", "4", "--process-id",
         str(i), "-o", d] for i, d in enumerate(dirs)], 600, cwd=work,
        env=env, logs=[os.path.join(d, "stdout.txt") for d in dirs])
    d23_s = time.time() - t0
    for d in dirs:
        with open(os.path.join(d, "log.txt")) as f:
            if "data-parallel refine over 4 ranks" not in f.read():
                fail(f"dp=4: {d}/log.txt does not log the data-parallel "
                     f"seed refine")
    exps = []
    for d in dirs:
        with open(os.path.join(d, "exp.mvs"), "rb") as f:
            exps.append(f.read())
    if any(e != exps[0] for e in exps[1:]):
        fail("dp=4: the four processes wrote different exp.mvs bytes")
    st23, c23, med23 = r_gates("dp=4 -r --distributed-expansion", dirs[0],
                               rsc2, n_seeds)
    ag23, ratio23 = agreement_gates("dp=4 vs phase 22", c23, c22, tol)
    log(f"dp=4 (4 CLI processes, gloo on one card): {d23_s:.1f} s wall; "
        f"seeds {st23['seed_accepted']}/{n_seeds} (data-parallel) in "
        f"{st23['seed_refine_s']:.2f} s; expansion {len(c23)} patches in "
        f"{st23['dist_expansion_s']:.2f} s over {st23['dist_rounds']} "
        f"rounds, {st23['dist_refined']} refined ({st23['dist_pps']:.1f} "
        f"refines/s), {st23['dist_spilled']} spilled; median {med23:.6f}; "
        f"the four exp.mvs bit-equal; against phase 22: agreement "
        f"{ag23[0]:.3f} / {ag23[1]:.3f}, count ratio {ratio23:.3f}")

    # 24. vp=5: five gloo ranks, one camera block each, against vp=1 here
    t0 = time.time()
    d24 = os.path.join(work, "vp1")
    rec1, seeds1, v1_launches, rounds1, v1_s, _ = dist_stage(nvm, work,
                                                             d24, dev)
    a1 = rec1.arena
    ranks = run_vp_workers(5, dict(nvm=nvm, work=work), timeout_s=600,
                           flag="--dist-rank")
    d24_s = time.time() - t0
    for k in ranks[0]:
        if k not in ("wall", "errs") and not all(
                np.array_equal(r[k], ranks[0][k]) for r in ranks[1:]):
            fail(f"vp=5: the ranks' arenas differ in {k}")
    r0 = ranks[0]
    errva_vp, errvb_vp, err2_vp = map(float, r0["errs"])
    errva, errvb = max(errva, errva_vp), max(errvb, errvb_vp)
    err2 = max(err2, err2_vp)
    vp_launches = dict(zip(sorted(CF.LAUNCHES), r0["launches"].tolist()))
    if not (vp_launches["view_moments"] and vp_launches["view_deviation"]
            and vp_launches["sampler"]) or any(
                vp_launches[k] for k in vp_launches
                if k not in ("view_moments", "view_deviation", "sampler")):
        fail(f"vp=5 expansion launched {vp_launches}: A, B and K2 expected "
             f"and no other kernel (K1 at 0)")
    if any(v1_launches[k] for k in v1_launches
           if k not in ("fitness", "sampler")) or not v1_launches["fitness"]:
        fail(f"vp=1 expansion launched {v1_launches}: K1 and K2 expected")
    if not np.array_equal(r0["seeds"], seeds1):
        fail("vp=5: the ranks' seed stage differs from this process's")
    acc5, acc1 = r0["acc0"], rounds1[0][0]
    both = acc5 & acc1
    agree = float((acc5 == acc1).mean())
    mdc = (float(np.median(np.linalg.norm(
        r0["center0"][both] - rounds1[0][1][both], axis=-1)))
        if both.any() else float("inf"))
    c5 = r0["d_center"][r0["alive"]]
    cv1 = a1.data["center"][:a1.count][a1.alive[:a1.count]]
    ag24 = cloud_agreement(c5, cv1, tol)
    med5 = float(np.median(rsc2.surface_distance(c5)))
    log(f"vp=5 (5 gloo ranks, one camera each) vs vp=1, {DIST_VP_ROUNDS} "
        f"rounds after the seed stage: {d24_s:.1f} s wall for both "
        f"(expansion vp=5 {float(r0['wall']):.2f} s, vp=1 {v1_s:.2f} s); "
        f"seed stages bit-equal; round 0: accepted {int(acc5.sum())} vs "
        f"{int(acc1.sum())} of {len(acc1)} rows, agreement {agree:.3f}, "
        f"median centre difference {mdc:.3g}; after round "
        f"{int(r0['rounds'])}: {len(c5)} vs {len(cv1)} patches, agreement "
        f"{ag24[0]:.3f} / {ag24[1]:.3f} at half a cell, median {med5:.6f}; "
        f"launches in the expansion vp=5 {vp_launches}, vp=1 {v1_launches}; "
        f"rank 0's first A, B and K2 calls against their twins: max |err| "
        f"{errva_vp:.3g}, {errvb_vp:.3g}, {err2_vp:.3g}")
    if agree < 0.95 or mdc > 1e-4 or both.sum() < 0.5 * acc1.sum():
        fail("vp=5: the first round disagrees with vp=1 (agreement >= "
             "0.95, median centre difference <= 1e-4)")
    if min(ag24) < 0.9 or not med5 < 2.5e-3:
        fail(f"vp=5: after {DIST_VP_ROUNDS} rounds the cloud agrees "
             f"{ag24[0]:.3f} / {ag24[1]:.3f} with vp=1's (gate >= 0.9), "
             f"median {med5:.6f} (gate < 2.5e-3)")
    del rec1

    # 25. the refine as CUDA graphs (ops/graphs.py), graphed against eager
    #     at the same generator seeds
    graphs_phase(scene, cfg, pb, nvm, work, exp_path, dev)

    # 26. psoExitChunk 10 captured (the fixed loop), and expand_step's
    #     refine of the whole budget replayed
    exit_phase(scene, cfg, pb, nvm, work, d22, rsc2, n_seeds, exp.centers,
               tol)
    shutil.rmtree(work)

    # 27. the main path at 4K: gpu_4k_run on the scene rendered since
    #     phase 1, and K1 and K2 against their twins at its shapes
    launches_4k, err1_4k, err2_4k = fourk_phase(render, gen)
    err1, err2 = max(err1, err1_4k), max(err2, err2_4k)

    # 28. the scene build on the card against the CPU twins (the pawn rig
    #     at 2x, two of phase 27's 4K cameras), and each of its kernels at
    #     the 4K camera's shapes
    builds, pyr_rows = scene_phase(rsc2, render[0], dev)
    shutil.rmtree(render[0])

    # 29. K1 past its camera tile on the 312-view hemisphere rig
    mv_launches, err1_mv, mv_rows = many_views_phase(dev)
    err1 = max(err1, err1_mv)

    kernels = [
        {"name": "fused_fitness", "route": "cuda",
         "source": "pais_mvs_tpu_torch/csrc/fitness.cu",
         "replaces": "pais_mvs_tpu/ops/pallas_fitness.py:552",
         "launches": r_launches["fitness"],
         "launches_seed_round": launches["fitness"],
         "launches_expansion_chunk": elaunches["fitness"],
         "launches_features_r": fr_launches["fitness"],
         "launches_refine_poses_r": b_launches["fitness"],
         "launches_reoptimize": v_launches["fitness"],
         "launches_dist_r": d_launches["fitness"],
         "launches_4k": launches_4k["fitness"],
         "launches_many_views": mv_launches["fitness"],
         "max_abs_err": err1, "max_abs_err_r": err1_r,
         "max_abs_err_b1": err1_v, "max_abs_err_4k": err1_4k,
         "max_abs_err_many_views": err1_mv, "many_views": mv_rows,
         "ms": k1_ms, "ms_in_loop": k1l_ms, "host_ms": k1_host,
         "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "warped_sampler", "route": "cuda",
         "source": "pais_mvs_tpu_torch/csrc/sampler.cu",
         "replaces": "pais_mvs_tpu/ops/pallas_fitness.py:67",
         "launches": r_launches["sampler"],
         "launches_seed_round": launches["sampler"],
         "launches_expansion_chunk": elaunches["sampler"],
         "launches_features_r": fr_launches["sampler"],
         "launches_refine_poses_r": b_launches["sampler"],
         "launches_reoptimize": v_launches["sampler"],
         "launches_dist_r": d_launches["sampler"],
         "launches_dist_vp": vp_launches["sampler"],
         "launches_4k": launches_4k["sampler"],
         "max_abs_err": err2, "max_abs_err_r": err2_r,
         "max_abs_err_b1": err2_v, "max_abs_err_dist_vp": err2_vp,
         "max_abs_err_4k": err2_4k,
         "ms": k2_ms, "host_ms": k2_host, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": lib_ms},
        {"name": "view_moments", "route": "cuda",
         "source": "pais_mvs_tpu_torch/csrc/view_fitness.cu",
         "replaces": "pais_mvs_tpu/ops/pallas_fitness.py:67",
         "launches": vlaunches["view_moments"],
         "launches_dist_vp": vp_launches["view_moments"],
         "max_abs_err": errva, "max_abs_err_dist_vp": errva_vp,
         "ms": va_ms, "ms_in_loop": val_ms, "host_ms": va_host,
         "plain_ms": va_plain, "bound_ms": va_bound,
         "bound_ms_in_loop": val_bound, "bound_by": va_by,
         "library_ms": lib_v_ms},
        {"name": "view_deviation", "route": "cuda",
         "source": "pais_mvs_tpu_torch/csrc/view_fitness.cu",
         "replaces": "pais_mvs_tpu/ops/pallas_fitness.py:67",
         "launches": vlaunches["view_deviation"],
         "launches_dist_vp": vp_launches["view_deviation"],
         "max_abs_err": errvb, "max_abs_err_dist_vp": errvb_vp,
         "ms": vb_ms, "ms_in_loop": vbl_ms, "host_ms": vb_host,
         "plain_ms": vb_plain, "bound_ms": vb_bound,
         "bound_ms_in_loop": vbl_bound, "bound_by": vb_by,
         "library_ms": lib_v_ms},
    ] + [
        {"name": f"microbench_{v}", "route": "cuda",
         "source": "pais_mvs_tpu_torch/csrc/microbench.cu",
         "replaces": "tools/microbench_kernel.py:52",
         "launches": mb_launches[f"microbench_{v}"], "max_abs_err": mb_err[v],
         "ms": mb[v][0], "ms_iqr": mb[v][1], "host_ms": mb[v][2],
         "plain_ms": mb_plain_ms, "bound_ms": mb_bound, "bound_by": mb_by,
         "library_ms": mb_lib_ms, "library": "grid_sample, sampling only",
         "registers": mb_regs[v].get("registers"),
         "spill_bytes": (mb_regs[v].get("spill_stores", 0)
                         + mb_regs[v].get("spill_loads", 0)
                         if mb_regs[v] else None),
         "smem_bytes": MB.smem_bytes(v), "sass_per_step": mb_sass[v][0],
         "grid": mb_grid if v == "d" else MB.CELLS} for v in MB.VARIANTS]
    for name in pyramid_entries():
        row = pyr_rows[name]
        extra = pyr_rows.get(f"{name}_moments")
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "pais_mvs_tpu_torch/csrc/pyramid.cu",
             "replaces": "no Pallas kernel: the numpy step at "
                         f"{PYRAMID_REPLACES[name]}",
             "launches": r_launches[name], "launches_4k": launches_4k[name],
             "max_abs_err": max(row["max_abs_err"], extra["max_abs_err"])
             if extra else row["max_abs_err"],
             **{k: row[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
             **({"ms_moments": extra["ms"],
                 "bound_ms_moments": extra["bound_ms"],
                 "plain_ms_moments": extra["plain_ms"]} if extra else {}),
             "shape": "4096x3072 camera, level 0 (resample: level 1)"})
    log(f"scene builds: {json.dumps(builds)}")
    for line in stop_children():
        log(f"stopped a child process left running: {line}")
    log(f"total {time.time() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--vp-rank"]:
        vp_worker(*map(int, sys.argv[2:5]), sys.argv[5])
    elif sys.argv[1:2] == ["--dist-rank"]:
        dist_worker(*map(int, sys.argv[2:5]), sys.argv[5])
    elif sys.argv[1:2] == ["--render-4k"]:
        render_4k(sys.argv[2])
    elif sys.argv[1:2] == ["--many-views"]:
        many_views_main()
    else:
        main()
