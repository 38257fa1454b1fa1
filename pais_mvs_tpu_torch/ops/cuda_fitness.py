"""The CUDA kernels of the port, their wrappers and their build.

The counterpart of ``pais_mvs_tpu/ops/pallas_fitness.py``:

  * ``score_windows`` — the fused photoconsistency fitness (K1,
    ``csrc/fitness.cu``), replacing ``_fused_kernel`` (pallas_fitness.py:552);
  * ``warped_samples`` — the warped-window sampler in its NCC mode (K2,
    ``csrc/sampler.cu``), replacing ``_sample_kernel`` (pallas_fitness.py:67)
    as ``warped_patch_vectors_pallas`` (:867) calls it;
  * ``view_moments`` and ``view_deviation`` — the view path's fitness
    (``csrc/view_fitness.cu``): the sampler's view mode (``_sample_kernel``
    as ``fitness_view_pallas``, view_fitness.py:283, and
    ``_ref_window_rows``, :198, call it) fused with the camera sums of
    ``fitness_view_jnp`` (view_fitness.py:162-172), one kernel before each
    of its two psums.

Each wrapper has the signature of its plain twin in ``ops/fitness.py``. A
CPU tensor runs the plain twin; a CUDA tensor launches the kernel or raises
(no fallback). The kernels are held to the jnp contracts of
``pais_mvs_tpu/ops/fitness.py`` and ``ops/view_fitness.py``, never to the
Pallas output: without the TPU's VMEM box there is no coverage limit and no
radius ceiling.

Build: ``nvcc`` compiles each ``csrc/*.cu`` (``SOURCES``) into its own
shared library with a plain C interface (no PyTorch headers, so each build
takes seconds), in parallel, at first use, into ``pais_mvs_tpu_torch/
_build/`` (keyed by a hash of the source and flags); ``ctypes`` binds each
C entry (``ENTRIES``; ``microbench.cu`` serves
``pais_mvs_tpu_torch/tools/microbench_kernel.py``, ``pyramid.cu`` the scene
build's wrappers in ``ops/pyramid.py``). Every launch adds one
to ``LAUNCHES[entry]``; nothing else touches the counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.ops import fitness as F

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = {"fitness": "fitness.cu", "sampler": "sampler.cu",
           "view_fitness": "view_fitness.cu", "microbench": "microbench.cu",
           "pyramid": "pyramid.cu"}
# the dynamic shared memory one block may take on sm_90 (227 KB)
SMEM_PER_BLOCK = 232448
# the widest rig whose fitness-kernel blocks run the one-pass loop for 8
# particles (kTile in csrc/fitness.cu); a wider rig's blocks run
# WIDE_WARPS particles and hold CAMERA_SPAN cameras (kWideWarps, kSpan):
# a row that sees more is scored in two passes, its first cameras sampled
# twice
CAMERA_TILE = 32
CAMERA_SPAN = 72
WIDE_WARPS = 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> (source, argument types); the C symbol is pais_<entry>
ENTRIES = {
    # images, edges, dims, yoff, C, L, Ha, Wa, H, pt, ref_cam, lod,
    # cam_mask, pvalid, active, wtable, B, P, radius, use_dist, use_diff,
    # diff_w, use_grad, grad_w, out, stream
    "fitness": ("fitness", [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                            _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F,
                            _P, _P]),
    # images, dims, yoff, C, L, Ha, Wa, H, pt, lod, cam_mask, B, radius,
    # out, stream
    "sampler": ("sampler", [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                            _I, _P, _P]),
    # images, edges, dims, yoff, C, L, Ha, Wa, H, pt, lod, act, cam_mask,
    # pvalid, ref_cam, own, B, P, radius, out, stream
    "view_moments": ("view_fitness", [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                                      _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                                      _P]),
    # images, dims, yoff, C, L, Ha, Wa, H, pt, lod, act, pvalid, mean, B, P,
    # radius, out, stream
    "view_deviation": ("view_fitness", [_P, _P, _P, _I, _I, _I, _I, _P, _P,
                                        _P, _P, _P, _P, _I, _I, _I, _P, _P]),
    # box, nbox, cells, out, stream
    "microbench_a": ("microbench", [_P, _I, _I, _P, _P]),
    "microbench_b": ("microbench", [_P, _I, _I, _P, _P]),
    # box, nbox, cells, y_lo, y_hi, c_lo, c_hi (the tap footprint), out,
    # stream
    "microbench_c": ("microbench", [_P, _I, _I, _I, _I, _I, _I, _P, _P]),
    # box, nbox, cells, y_lo, y_hi, c_lo, c_hi, grid, out, stream
    "microbench_d": ("microbench", [_P, _I, _I, _I, _I, _I, _I, _I, _P,
                                    _P]),
    # the scene build (csrc/pyramid.cu, wrapped in ops/pyramid.py)
    # img, h, w, channels, rgb_out, rgb_out width, gray, stream
    "pyramid_gray": ("pyramid", [_P, _I, _I, _I, _P, _I, _P, _P]),
    # in, n, w, out, out_sq (or null), stream
    "pyramid_col_scan": ("pyramid", [_P, _I, _I, _P, _P, _P]),
    # in, rows, n, out, stream
    "pyramid_row_scan": ("pyramid", [_P, _I, _I, _P, _P]),
    # f, F, n_in, w, n_out, out, stream
    "pyramid_resample_rows": ("pyramid", [_P, _P, _I, _I, _I, _P, _P]),
    # tmp, G, h, n_in, n_out, out, stream
    "pyramid_resample_cols": ("pyramid", [_P, _P, _I, _I, _I, _P, _P]),
    # g, h, w, lohi, stream
    "pyramid_edge_range": ("pyramid", [_P, _I, _I, _P, _P]),
    # g, h, w, lohi, I, radius, y0, images, edges, var, Wa, stream
    "pyramid_pack": ("pyramid", [_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _I,
                                 _P]),
}

LAUNCHES = {name: 0 for name in ENTRIES}
_LIBS: dict = {}          # entry -> (C function, error-string function)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(source: str) -> Path:
    src = (CSRC / SOURCES[source]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source}_{tag[:16]}.so"


def build_kernels(sources=None) -> dict:
    """Compile (in parallel) and bind every source not yet bound. Returns
    ``{source: compiler output}`` for the sources compiled by this call
    (``-Xptxas -v`` reports registers, shared memory and spills)."""
    bound = {ENTRIES[e][0] for e in _LIBS}
    sources = [s for s in (sources or SOURCES) if s not in bound]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sources:
        out = _lib_path(source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[source] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / SOURCES[source])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs = {}
    try:
        for source, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {SOURCES[source]}:\n{log}")
            os.replace(tmp, out)     # atomic: a concurrent loader never sees
            logs[source] = log       # a half-written library
    finally:                         # on failure, stop the other compiles
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for entry, (source, argtypes) in ENTRIES.items():
        if source not in sources:
            continue
        lib = ctypes.CDLL(str(_lib_path(source)))
        fn = getattr(lib, f"pais_{entry}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"pais_{source}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[entry] = (fn, err)
    return logs


def fitness_smem_bytes(num_cameras: int, radius: int) -> int:
    """The shared memory of one block of the fitness kernel: for each camera
    it holds (``min(num_cameras, CAMERA_SPAN)``), every particle's record
    (12 floats) and every thread's sample (8 particles of 32 threads on a
    rig of at most ``CAMERA_TILE``, ``WIDE_WARPS`` on a wider one), its
    limits and index; and the distance table (as ``fitness_smem_bytes`` in
    csrc/fitness.cu)."""
    warps = 8 if num_cameras <= CAMERA_TILE else WIDE_WARPS
    held = min(num_cameras, CAMERA_SPAN)
    return (warps * (12 + 32) + 3) * 4 * held + 4 * (2 * radius + 1) ** 2


def fitness_max_radius(num_cameras: int) -> int:
    """The largest window radius whose fitness-kernel block fits one
    block's shared memory on a rig of ``num_cameras``."""
    r = 0
    while fitness_smem_bytes(num_cameras, r + 1) <= SMEM_PER_BLOCK:
        r += 1
    return r


def _launch(entry: str, *args) -> None:
    if entry not in _LIBS:
        build_kernels([ENTRIES[entry][0]])
    fn, err = _LIBS[entry]
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    LAUNCHES[entry] += 1


def _check(name: str, t: torch.Tensor, dtype, shape=None) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _atlas_args(pyrs):
    C, Ha, Wa = pyrs.images.shape
    L = pyrs.dims.shape[1]
    return (_check("images", pyrs.images, torch.bfloat16),
            _check("dims", pyrs.dims, torch.int32, (C, L, 2)),
            _check("yoff", pyrs.yoff, torch.int32, (L + 1,)),
            C, L, Ha, Wa)


def score_windows(pyrs, cfg: MvsConfig, H, pt, ref_cam, cam_mask, lod,
                  pvalid, active=None):
    """K1: the fitness of every particle's warped window.

    H [B, P, C, 3, 3] f32, pt [B, P, 2] f32, ref_cam [B] int32, cam_mask
    [B, C] bool, lod [B] int32, pvalid [B, P] bool, active [B] bool or None
    -> [B, P] f32 (BIG = rejected; inactive swarms get BIG).

    Any number of cameras: a row that sees more than ``CAMERA_SPAN`` is
    scored in two passes, its first cameras sampled twice. The one limit
    is the window: the distance table and the records and samples of the
    cameras a block holds must fit one block's shared memory
    (``fitness_smem_bytes``), so r <= 107 on a rig of 32 cameras and r <=
    105 on one of ``CAMERA_SPAN`` or more (``fitness_max_radius``); a
    larger radius raises ValueError."""
    if H.device.type == "cpu":
        return F.score_windows(pyrs, cfg, H, pt, ref_cam, cam_mask, lod,
                               pvalid, active)
    B, P, C = H.shape[:3]
    r = cfg.patch_radius
    smem = fitness_smem_bytes(C, r)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"a window of radius {r} needs {smem} bytes of shared memory "
            f"per fitness-kernel block for its distance table and the "
            f"samples and records of {min(C, CAMERA_SPAN)} cameras; one "
            f"block can take {SMEM_PER_BLOCK} (r <= "
            f"{fitness_max_radius(C)} on this rig of {C} cameras)")
    images, dims, yoff, C_atlas, L, Ha, Wa = _atlas_args(pyrs)
    if C_atlas != C:
        raise ValueError(f"H has {C} cameras, the atlas {C_atlas}")
    table = F.dist_table_on(r, cfg.dist_weighting, H.device)
    out = torch.empty((B, P), dtype=torch.float32, device=H.device)
    _launch(
        "fitness", images,
        _check("edges", pyrs.edges, torch.bfloat16, pyrs.images.shape),
        dims, yoff, C, L, Ha, Wa,
        _check("H", H, torch.float32, (B, P, C, 3, 3)),
        _check("pt", pt, torch.float32, (B, P, 2)),
        _check("ref_cam", ref_cam, torch.int32, (B,)),
        _check("lod", lod, torch.int32, (B,)),
        _check("cam_mask", cam_mask, torch.bool, (B, C)),
        _check("pvalid", pvalid, torch.bool, (B, P)),
        None if active is None else _check("active", active, torch.bool,
                                           (B,)),
        table.data_ptr(), B, P, r,
        int(cfg.adaptive_distance_enable),
        int(cfg.adaptive_difference_enable), float(cfg.diff_weighting),
        int(cfg.adaptive_gradient_enable), float(cfg.gradient_weighting),
        out.data_ptr())
    return out


def warped_samples(pyrs, H, pt, lod, cam_mask, radius: int):
    """K2: bilinear samples of every (patch, camera, window pixel), INVALID
    outside the margins [0, dim-1), where w = 0, or for a masked camera.

    H [B, C, 3, 3] f32, pt [B, 2] f32, lod [B] int32, cam_mask [B, C] bool
    -> [B, C, W2] f32."""
    if H.device.type == "cpu":
        return F.warped_samples(pyrs, H, pt, lod, cam_mask, radius)
    B, C = cam_mask.shape
    W2 = (2 * radius + 1) ** 2
    images, dims, yoff, C_atlas, L, Ha, Wa = _atlas_args(pyrs)
    if C_atlas != C:
        raise ValueError(f"cam_mask has {C} cameras, the atlas {C_atlas}")
    out = torch.empty((B, C, W2), dtype=torch.float32, device=H.device)
    _launch("sampler", images, dims, yoff, C, L, Ha, Wa,
            _check("H", H, torch.float32, (B, C, 3, 3)),
            _check("pt", pt, torch.float32, (B, 2)),
            _check("lod", lod, torch.int32, (B,)),
            _check("cam_mask", cam_mask, torch.bool, (B, C)),
            B, radius, out.data_ptr())
    return out


def view_smem_bytes(num_cameras: int, radius: int, planes: int) -> int:
    """The shared memory of one block of the view kernels: one 12-float
    record per camera and ``planes`` window tiles (as ``view_smem_bytes``
    in csrc/view_fitness.cu)."""
    return 4 * 12 * num_cameras + 4 * planes * (2 * radius + 1) ** 2


def _view_args(pyrs, H, pt, lod, act, pvalid, radius: int, planes: int):
    """The arguments the two view kernels share, checked; (B, P, C) and
    the rest."""
    B, P, C = H.shape[:3]
    smem = view_smem_bytes(C, radius, planes)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"a block of {C} cameras at r={radius} needs {smem} bytes of "
            f"shared memory per view-kernel block for its camera records and "
            f"window tiles; one block can take {SMEM_PER_BLOCK}")
    images, dims, yoff, C_atlas, L, Ha, Wa = _atlas_args(pyrs)
    if C_atlas != C:
        raise ValueError(f"H has {C} cameras, the atlas {C_atlas}")
    return (B, P, C), (images, dims, yoff, C, L, Ha, Wa,
                       _check("H", H, torch.float32, (B, P, C, 3, 3)),
                       _check("pt", pt, torch.float32, (B, P, 2)),
                       _check("lod", lod, torch.int32, (B,)),
                       _check("act", act, torch.bool, (B, C)))


def view_moments(pyrs, H, pt, lod, act, cam_mask, pvalid, ref_cam, own,
                 radius: int, edges: bool):
    """Kernel A of the view fitness: per window pixel of every (patch,
    particle), over the block's cameras, the valid samples' sum (plane 0),
    the cam_mask cameras with an invalid sample (plane 1), and the
    reference camera's intensity (plane 2) and, with ``edges``, edge
    weight (plane 3) where this rank owns it, else 0.

    H [B, P, c, 3, 3] f32, pt [B, P, 2] f32, lod [B] int32, act [B, c]
    bool, cam_mask [B, c] bool, pvalid [B, P] bool, ref_cam [B] int32 (an
    index into the block), own [B] bool -> [n, B, P, W2] f32, n = 4 with
    ``edges``, else 3."""
    if H.device.type == "cpu":
        return F.view_moments(pyrs, H, pt, lod, act, cam_mask, pvalid,
                              ref_cam, own, radius, edges)
    planes = 4 if edges else 3
    (B, P, C), args = _view_args(pyrs, H, pt, lod, act, pvalid, radius,
                                 planes)
    out = torch.empty((planes, B, P, (2 * radius + 1) ** 2),
                      dtype=torch.float32, device=H.device)
    _launch("view_moments", args[0],
            _check("edges", pyrs.edges, torch.bfloat16, pyrs.images.shape)
            if edges else None, *args[1:],
            _check("cam_mask", cam_mask, torch.bool, (B, C)),
            _check("pvalid", pvalid, torch.bool, (B, P)),
            _check("ref_cam", ref_cam, torch.int32, (B,)),
            _check("own", own, torch.bool, (B,)),
            B, P, radius, out.data_ptr())
    return out


def view_deviation(pyrs, H, pt, lod, act, pvalid, mean, radius: int):
    """Kernel B of the view fitness: per window pixel of every (patch,
    particle), the sum over the block's cameras of |sample - mean| for the
    valid samples; 0 where the particle is invalid or no camera is active.

    H, pt, lod, act, pvalid as ``view_moments``; mean [B, P, W2] f32 ->
    [B, P, W2] f32."""
    if H.device.type == "cpu":
        return F.view_deviation(pyrs, H, pt, lod, act, pvalid, mean, radius)
    (B, P, C), args = _view_args(pyrs, H, pt, lod, act, pvalid, radius, 1)
    W2 = (2 * radius + 1) ** 2
    out = torch.empty((B, P, W2), dtype=torch.float32, device=H.device)
    _launch("view_deviation", *args,
            _check("pvalid", pvalid, torch.bool, (B, P)),
            _check("mean", mean, torch.float32, (B, P, W2)),
            B, P, radius, out.data_ptr())
    return out


def patch_fitness(scene, cfg: MvsConfig, ref_cam, cam_mask, lod, ray, pos,
                  active=None):
    """``ops.fitness.patch_fitness`` with its pixel stage on K1 for CUDA
    tensors (the plain twin for CPU tensors)."""
    return F.patch_fitness(scene, cfg, ref_cam, cam_mask, lod, ray, pos,
                           active, scorer=score_windows)


def warped_patch_vectors(scene, cfg: MvsConfig, center, normal, ref_cam,
                         cam_mask, lod):
    """``ops.fitness.warped_patch_vectors`` with its sampling on K2 for
    CUDA tensors (the plain twin for CPU tensors)."""
    return F.warped_patch_vectors(scene, cfg, center, normal, ref_cam,
                                  cam_mask, lod, sampler=warped_samples)
