"""Camera rig and scene containers: plain dataclasses of tensors.

The PyTorch counterpart of ``pais_mvs_tpu/models/camera.py``. The reference
keeps a ``vector<Camera>`` of heavyweight objects, each owning its own
OpenCV matrices and pyramid (TMVS/mvs/camera.h). Here, as in the JAX
package, there is one stacked tensor per quantity so every batched op
indexes cameras with plain gathers. Host-side construction is float64
numpy; every float array is cast to float32 explicitly (``torch.as_tensor``
would keep numpy's float64, where JAX with x64 off silently casts).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from pais_mvs_tpu_torch import resolve_device
from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.ops import pyramid as pyr


@dataclass
class CameraParams:
    """Host-side description of one camera (as parsed from NVM/MVS files).

    Mirrors the reference ctor inputs (TMVS/mvs/camera.cpp:45): focal may be
    anisotropic (NVM2), principal (-1,-1) means image center, quaternion is
    (w, x, y, z), center is the camera position in world coordinates.
    """

    file_name: str
    focal: np.ndarray          # [2]
    principal: np.ndarray      # [2]; (-1,-1) -> image center
    quaternion: np.ndarray     # [4] (w, x, y, z)
    center: np.ndarray         # [3]
    radial_distortion: float = 0.0


def _np_quat_to_rotation(q: np.ndarray) -> np.ndarray:
    qq = np.linalg.norm(q)
    if qq > 0:
        w, x, y, z = q / qq
    else:
        w, x, y, z = 1.0, 0.0, 0.0, 0.0
    return np.array([
        [w*w + x*x - y*y - z*z, 2*(x*y - z*w), 2*(y*w + z*x)],
        [2*(x*y + w*z), y*y + w*w - z*z - x*x, 2*(z*y - x*w)],
        [2*(x*z - y*w), 2*(y*z + w*x), z*z + w*w - y*y - x*x],
    ])


def _to(obj, device):
    return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                        for f in dataclasses.fields(obj)})


@dataclass
class CameraRig:
    """Stacked camera geometry; all tensors lead with the camera axis C."""

    R: torch.Tensor          # [C, 3, 3] f32 rotation (world -> camera)
    T: torch.Tensor          # [C, 3] translation = -R @ center
    center: torch.Tensor     # [C, 3]
    focal: torch.Tensor      # [C, 2]
    principal: torch.Tensor  # [C, 2]
    distortion: torch.Tensor  # [C]
    KR: torch.Tensor         # [C, 3, 3]
    KT: torch.Tensor         # [C, 3]
    optical: torch.Tensor    # [C, 3] optical axis in world (R^T e_z)
    quaternion: torch.Tensor  # [C, 4]
    max_lod: torch.Tensor    # [C] int32

    @property
    def num_cameras(self) -> int:
        return self.R.shape[0]

    def to(self, device) -> "CameraRig":
        return _to(self, device)


@dataclass
class PyramidSet:
    """Packed image pyramids for every camera, as a vertical mip-atlas:
    level ``l`` of camera ``c`` lives in ``images[c, yoff[l]:yoff[l]+h_l,
    :w_l]`` (bands are 8-row aligned)."""

    images: torch.Tensor  # [C, Ha, Wa] bf16 gray 0..255 (0 = background/pad)
    edges: torch.Tensor   # [C, Ha, Wa] bf16 in [0, 1]
    dims: torch.Tensor    # [C, L, 2] int32 (h, w) per level; (0, 0) if absent
    rgb: torch.Tensor     # [C, Hmax, Wmax, 3] uint8 level-0 color
    var: torch.Tensor     # [C, Ha, Wa] bf16 patch-window variance (-1 = OOB)
    yoff: torch.Tensor    # [L+1] int32 atlas band row offsets (last = Ha)

    @property
    def num_levels(self) -> int:
        return self.dims.shape[1]

    def to(self, device) -> "PyramidSet":
        return _to(self, device)


@dataclass
class Scene:
    rig: CameraRig
    pyramids: PyramidSet

    @property
    def num_cameras(self) -> int:
        return self.rig.num_cameras

    @property
    def device(self) -> torch.device:
        return self.rig.R.device

    def to(self, device) -> "Scene":
        return Scene(rig=self.rig.to(device),
                     pyramids=self.pyramids.to(device))


def undistort_image(img: np.ndarray, focal, principal,
                    r_dist: float) -> np.ndarray:
    """Resample a radially-distorted image onto the pinhole model.

    The reference's distortion (TMVS/mvs/camera.cpp:148-155): a point with
    normalized coords n lands at pixel (1 + r*|n|^2) * f * n + pp. The
    undistorted (pinhole) image therefore samples the input at exactly
    that forward-mapped position — no iterative inversion needed.
    """
    h, w = img.shape[:2]
    f = np.asarray(focal, float)
    pp = np.asarray(principal, float)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    nx = (xs - pp[0]) / f[0]
    ny = (ys - pp[1]) / f[1]
    s = 1.0 + r_dist * (nx * nx + ny * ny)
    u = np.clip(s * f[0] * nx + pp[0], 0, w - 1.001)
    v = np.clip(s * f[1] * ny + pp[1], 0, h - 1.001)
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    fx = (u - x0)[..., None] if img.ndim == 3 else u - x0
    fy = (v - y0)[..., None] if img.ndim == 3 else v - y0
    out = (img[y0, x0] * (1 - fx) * (1 - fy)
           + img[y0, np.minimum(x0 + 1, w - 1)] * fx * (1 - fy)
           + img[np.minimum(y0 + 1, h - 1), x0] * (1 - fx) * fy
           + img[np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)]
           * fx * fy)
    return out.astype(img.dtype)


def undistort_points(pts: np.ndarray, focal, principal,
                     r_dist: float, iters: int = 4) -> np.ndarray:
    """Map distorted-image pixel measurements to pinhole pixels (the
    inverse of the forward model above), via Newton on the radial scalar:
    rho_d = (1 + r t^2) t  for  t = |n_undistorted|."""
    f = np.asarray(focal, float)
    pp = np.asarray(principal, float)
    nd = (np.asarray(pts, float) - pp) / f
    rho = np.linalg.norm(nd, axis=-1)
    t = rho.copy()
    for _ in range(iters):
        g = t + r_dist * t ** 3 - rho
        dg = 1.0 + 3.0 * r_dist * t * t
        t = t - g / np.where(np.abs(dg) < 1e-9, 1.0, dg)
    scale = np.where(rho > 1e-12, t / np.where(rho > 0, rho, 1.0), 1.0)
    return nd * scale[..., None] * f + pp


def build_scene(params: Sequence[CameraParams],
                rgb_images: Sequence[np.ndarray],
                cfg: MvsConfig, device="cuda") -> Scene:
    """Assemble the device-side Scene from parsed cameras + decoded images.

    ``rgb_images[i]`` is a uint8 [H, W, 3] (or gray [H, W]) array for camera
    ``i``. Per-camera derived quantities follow TMVS/mvs/camera.cpp:45-136.
    With ``cfg.apply_distortion`` images are undistorted here and the
    engine runs pure pinhole everywhere (as ``pais_mvs_tpu`` does).
    """
    dev = resolve_device(device)
    C = len(params)
    if C != len(rgb_images):
        raise ValueError(f"{C} cameras but {len(rgb_images)} images")
    if cfg.apply_distortion:
        rgb_images = [
            undistort_image(img, p.focal,
                            (np.array([img.shape[1] >> 1,
                                       img.shape[0] >> 1], float)
                             if p.principal[0] < 0 and p.principal[1] < 0
                             else p.principal),
                            float(p.radial_distortion))
            if abs(float(p.radial_distortion)) > 1e-12 else img
            for p, img in zip(params, rgb_images)]
    R = np.zeros((C, 3, 3)); T = np.zeros((C, 3)); centers = np.zeros((C, 3))
    focal = np.zeros((C, 2)); principal = np.zeros((C, 2))
    dist = np.zeros(C); KR = np.zeros((C, 3, 3)); KT = np.zeros((C, 3))
    optical = np.zeros((C, 3)); quat = np.zeros((C, 4))
    max_lods = np.zeros(C, dtype=np.int32)

    levels_all, edges_all, dims_all, vars_all = [], [], [], []
    hmax = max(img.shape[0] for img in rgb_images)
    wmax = max(img.shape[1] for img in rgb_images)
    rgb_packed = np.zeros((C, hmax, wmax, 3), dtype=np.uint8)

    for i, (p, img) in enumerate(zip(params, rgb_images)):
        h, w = img.shape[:2]
        gray = pyr.rgb_to_gray(img)
        ml = pyr.max_lod_for(w, h, cfg.lod_ratio, cfg.max_lod)
        max_lods[i] = ml
        lv, ed, dm = pyr.build_pyramid(gray, cfg.lod_ratio, ml)
        levels_all.append(lv); edges_all.append(ed); dims_all.append(dm)
        vars_all.append([pyr.window_variance_map(g, cfg.patch_radius)
                         for g in lv])
        if img.ndim == 3:
            rgb_packed[i, :h, :w] = img
        else:
            rgb_packed[i, :h, :w] = img[..., None]

        Ri = _np_quat_to_rotation(np.asarray(p.quaternion, dtype=np.float64))
        ci = np.asarray(p.center, dtype=np.float64)
        fi = np.asarray(p.focal, dtype=np.float64)
        pp = np.asarray(p.principal, dtype=np.float64)
        if pp[0] < 0 and pp[1] < 0:
            # image-center principal point uses integer halves (camera.cpp:101-106)
            pp = np.array([w >> 1, h >> 1], dtype=np.float64)
        K = np.array([[fi[0], 0, pp[0]], [0, fi[1], pp[1]], [0, 0, 1.0]])
        Ti = -Ri @ ci
        R[i], T[i], centers[i] = Ri, Ti, ci
        focal[i], principal[i], dist[i] = fi, pp, p.radial_distortion
        KR[i], KT[i] = K @ Ri, K @ Ti
        optical[i] = Ri.T @ np.array([0.0, 0.0, 1.0])
        quat[i] = np.asarray(p.quaternion, dtype=np.float64)

    L = int(max_lods.max()) + 1
    images, edges, dims, yoff = pyr.pack_pyramids(levels_all, edges_all,
                                                  dims_all, L)
    var_maps = pyr.pack_variance_maps(vars_all, dims_all, L)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def bf16(a):
        # float32 -> bf16 rounds to nearest even, as numpy's bf16 cast in
        # the JAX package does, so the atlases compare bit for bit
        return f32(a).to(torch.bfloat16)

    rig = CameraRig(
        R=f32(R), T=f32(T), center=f32(centers), focal=f32(focal),
        principal=f32(principal), distortion=f32(dist), KR=f32(KR),
        KT=f32(KT), optical=f32(optical), quaternion=f32(quat),
        max_lod=torch.as_tensor(max_lods, dtype=torch.int32, device=dev),
    )
    # bf16 atlases, as pais_mvs_tpu/models/camera.py:236-245 keeps them:
    # 0..255 level-0 intensities are bf16-exact (background test preserved)
    pyrs = PyramidSet(
        images=bf16(images), edges=bf16(edges),
        dims=torch.as_tensor(dims, dtype=torch.int32, device=dev),
        rgb=torch.as_tensor(rgb_packed, device=dev),
        var=bf16(var_maps),
        yoff=torch.as_tensor(yoff, dtype=torch.int32, device=dev))
    return Scene(rig=rig, pyramids=pyrs)
