"""Camera rig and scene containers: plain dataclasses of tensors.

The PyTorch counterpart of ``pais_mvs_tpu/models/camera.py``. The reference
keeps a ``vector<Camera>`` of heavyweight objects, each owning its own
OpenCV matrices and pyramid (TMVS/mvs/camera.h). Here, as in the JAX
package, there is one stacked tensor per quantity so every batched op
indexes cameras with plain gathers. The rig is built on the host in
float64 numpy and every float array cast to float32 explicitly
(``torch.as_tensor`` would keep numpy's float64, where JAX with x64 off
silently casts); the image pyramids are built on the scene's device
(``ops/pyramid.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pais_mvs_tpu_torch import resolve_device
from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.ops import pyramid as pyr
from pais_mvs_tpu_torch.trace import Trace


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

    def view_block(self, index: int, size: int) -> "Scene":
        """Camera block ``index`` of ``size``: the big per-camera atlases
        (images, edges, var, rgb) keep cameras ``[offset, offset +
        c_local)``; the rig, ``dims`` and ``yoff`` stay whole. The layout
        of one view shard (pais_mvs_tpu/parallel/mesh.py:55-65)."""
        sl = _block_slice(self.num_cameras, index, size)
        p = self.pyramids
        return Scene(rig=self.rig, pyramids=PyramidSet(
            images=p.images[sl], edges=p.edges[sl], dims=p.dims,
            rgb=p.rgb[sl], var=p.var[sl], yoff=p.yoff))


def _block_slice(num_cameras: int, index: int, size: int) -> slice:
    """Cameras of view block ``index`` of ``size`` equal blocks."""
    if size < 1 or num_cameras % size:
        raise ValueError(f"the view axis of size {size} must divide the "
                         f"camera count {num_cameras}")
    if not 0 <= index < size:
        raise ValueError(f"view block {index} is outside 0..{size - 1}")
    c_local = num_cameras // size
    return slice(index * c_local, (index + 1) * c_local)


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
                cfg: MvsConfig, device="cuda",
                view_block: Optional[Tuple[int, int]] = None,
                split: Optional[dict] = None,
                trace: Optional[Trace] = None) -> Scene:
    """Assemble the device-side Scene from parsed cameras + decoded images.

    ``rgb_images[i]`` is a uint8 [H, W, 3] (or gray [H, W]) array for camera
    ``i``. Per-camera derived quantities follow TMVS/mvs/camera.cpp:45-136.
    With ``cfg.apply_distortion`` images are undistorted here, on the host
    (a camera with |r| <= 1e-12 keeps its image untouched), and the engine
    runs pure pinhole everywhere (as ``pais_mvs_tpu`` does).

    The host keeps what needs no pixels: each level's size, the atlas
    layout and the camera matrices. Each camera's image is uploaded, one
    at a time, into one reused buffer on ``device``, and ``ops/pyramid.py``
    builds its atlas planes there (``build_camera``: the kernels of
    ``csrc/pyramid.cu`` on the card, their plain twins on the CPU). The
    atlases are the JAX package's numpy build, bit for bit.

    ``view_block=(index, size)`` builds ``Scene.view_block(index, size)``:
    only the block's cameras are built; the layout (``yoff``, the atlas
    width) still comes from every camera. ``split``, when given, gets the
    seconds of the undistortion (``undistort_s``), the uploads
    (``upload_s``, host clock) and the pyramid steps (``kernel_s``: CUDA
    events on the card, the host clock on the CPU), from the spans
    ``scene/undistort``, ``scene/upload`` and ``scene/pyramid`` (one a
    camera) recorded in ``trace`` (a ``trace.Trace``; a fresh one when
    None).
    """
    tr = Trace() if trace is None else trace
    dev = resolve_device(device)
    C = len(params)
    if C != len(rgb_images):
        raise ValueError(f"{C} cameras but {len(rgb_images)} images")
    blk = slice(None) if view_block is None else _block_slice(C, *view_block)
    with tr.span("scene/undistort") as undistort:
        if cfg.apply_distortion:
            rgb_images = [
                undistort_image(img, p.focal,
                                (np.array([img.shape[1] >> 1,
                                           img.shape[0] >> 1], float)
                                 if p.principal[0] < 0
                                 and p.principal[1] < 0
                                 else p.principal),
                                float(p.radial_distortion))
                if abs(float(p.radial_distortion)) > 1e-12 else img
                for p, img in zip(params, rgb_images)]
    R = np.zeros((C, 3, 3)); T = np.zeros((C, 3)); centers = np.zeros((C, 3))
    focal = np.zeros((C, 2)); principal = np.zeros((C, 2))
    dist = np.zeros(C); KR = np.zeros((C, 3, 3)); KT = np.zeros((C, 3))
    optical = np.zeros((C, 3)); quat = np.zeros((C, 4))
    max_lods = np.zeros(C, dtype=np.int32)
    dims_all = []

    for i, (p, img) in enumerate(zip(params, rgb_images)):
        h, w = img.shape[:2]
        ml = pyr.max_lod_for(w, h, cfg.lod_ratio, cfg.max_lod)
        max_lods[i] = ml
        dims_all.append(pyr.level_dims(h, w, cfg.lod_ratio, ml))

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
    yoff, wa = pyr.atlas_offsets(dims_all, L)
    dims = np.zeros((C, L, 2), dtype=np.int32)
    for i, d in enumerate(dims_all):
        dims[i, :len(d)] = d
    hmax = max(img.shape[0] for img in rgb_images)
    wmax = max(img.shape[1] for img in rgb_images)
    cams = range(C)[blk]
    # bf16 atlases, as pais_mvs_tpu/models/camera.py:236-245 keeps them:
    # 0..255 level-0 intensities are bf16-exact (background test
    # preserved); padding 0, -1 (window out of bounds) for the variance
    shape = (len(cams), int(yoff[-1]), wa)
    images = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    edges = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    var = torch.full(shape, -1.0, dtype=torch.bfloat16, device=dev)
    rgb = torch.zeros((len(cams), hmax, wmax, 3), dtype=torch.uint8,
                      device=dev)
    on_card = dev.type == "cuda"
    staging = torch.empty(max(rgb_images[i].size for i in cams),
                          dtype=torch.uint8, device=dev)
    t_upload, t_kernel, events = 0.0, 0.0, []
    for j, i in enumerate(cams):
        img = pyr.host_tensor(rgb_images[i])
        if on_card:
            torch.cuda.synchronize(dev)    # the upload alone on the clock
        with tr.span("scene/upload") as upload:
            up = staging[:img.numel()].view(img.shape)
            up.copy_(img)
        t_upload += upload.seconds
        if on_card:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        with tr.span("scene/pyramid") as pyramid:
            pyr.build_camera(up, dims_all[i], cfg.patch_radius, yoff,
                             images[j], edges[j], var[j], rgb[j])
        t_kernel += pyramid.seconds
        if on_card:
            events[-1][1].record()
    if on_card:
        torch.cuda.synchronize(dev)
        t_kernel = sum(a.elapsed_time(b) for a, b in events) / 1e3
    if split is not None:
        split.update(undistort_s=undistort.seconds, upload_s=t_upload,
                     kernel_s=t_kernel)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    rig = CameraRig(
        R=f32(R), T=f32(T), center=f32(centers), focal=f32(focal),
        principal=f32(principal), distortion=f32(dist), KR=f32(KR),
        KT=f32(KT), optical=f32(optical), quaternion=f32(quat),
        max_lod=torch.as_tensor(max_lods, dtype=torch.int32, device=dev),
    )
    pyrs = PyramidSet(
        images=images, edges=edges,
        dims=torch.as_tensor(dims, dtype=torch.int32, device=dev),
        rgb=rgb, var=var,
        yoff=torch.as_tensor(yoff, dtype=torch.int32, device=dev))
    return Scene(rig=rig, pyramids=pyrs)
