"""The two CUDA kernels of the slice, their wrappers and their build.

The counterpart of ``pais_mvs_tpu/ops/pallas_fitness.py``:

  * ``score_windows`` — the fused photoconsistency fitness (K1,
    ``csrc/fitness.cu``), replacing ``_fused_kernel`` (pallas_fitness.py:552);
  * ``warped_samples`` — the warped-window sampler (K2,
    ``csrc/sampler.cu``), replacing ``_sample_kernel`` (pallas_fitness.py:67).

Each wrapper has the signature of its plain twin in ``ops/fitness.py``. A
CPU tensor runs the plain twin; a CUDA tensor launches the kernel or raises
(no fallback). Both kernels are held to the jnp contract of
``pais_mvs_tpu/ops/fitness.py``, never to the Pallas output: without the
TPU's VMEM box there is no coverage limit and no radius ceiling.

Build: ``nvcc`` compiles each ``csrc/*.cu`` into its own shared library with
a plain C interface (no PyTorch headers, so each build takes seconds), in
parallel, at first use, into ``pais_mvs_tpu_torch/_build/`` (keyed by a hash
of the source and flags); ``ctypes`` binds it. Every launch adds one to
``LAUNCHES[name]``; nothing else touches the counts.
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
KERNELS = {"fitness": "fitness.cu", "sampler": "sampler.cu"}
MAX_CAMERAS = 8           # fitness.cu's per-pixel register array (kMaxCams)

LAUNCHES = {name: 0 for name in KERNELS}
_LIBS: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # images, edges, dims, yoff, C, L, Ha, Wa, H, pt, ref_cam, lod,
    # cam_mask, pvalid, active, wtable, B, P, radius, use_dist, use_diff,
    # diff_w, use_grad, grad_w, out, stream
    "fitness": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                _P, _I, _I, _I, _I, _I, _F, _I, _F, _P, _P],
    # images, dims, yoff, C, L, Ha, Wa, H, pt, lod, cam_mask, B, radius,
    # out, stream
    "sampler": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / KERNELS[name]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def build_kernels(names=None) -> dict:
    """Compile (in parallel) and load every kernel not yet loaded. Returns
    ``{name: compiler output}`` for the kernels compiled by this call
    (``-Xptxas -v`` reports registers, shared memory and spills)."""
    names = [n for n in (names or KERNELS) if n not in _LIBS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {KERNELS[name]}:\n{log}")
        os.replace(tmp, out)         # atomic: a concurrent loader never sees
        logs[name] = log             # a half-written library
    for name in names:
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, f"pais_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"pais_{name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = (fn, err)
    return logs


def _launch(name: str, *args) -> None:
    if name not in _LIBS:
        build_kernels([name])
    fn, err = _LIBS[name]
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    LAUNCHES[name] += 1


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
    -> [B, P] f32 (BIG = rejected; inactive swarms get BIG)."""
    if H.device.type == "cpu":
        return F.score_windows(pyrs, cfg, H, pt, ref_cam, cam_mask, lod,
                               pvalid, active)
    B, P, C = H.shape[:3]
    if C > MAX_CAMERAS:
        raise ValueError(f"fitness kernel takes at most {MAX_CAMERAS} "
                         f"cameras, got {C}")
    r = cfg.patch_radius
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
