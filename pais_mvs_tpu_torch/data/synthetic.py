"""Synthetic multi-view scenes with analytic ground truth.

The reference repo ships no image data (the pawn sequence lives outside the
tree), so correctness and benchmarking are anchored on procedurally rendered
scenes where every quantity — depth, normal, visibility — has a closed form:

* a textured Lambertian plane z = 0 (optionally tilted / gently curved)
  rendered through ideal pinhole cameras on an arc above it;
* value-noise texture (bilinear interpolation of random grids, multi-octave)
  so photoconsistency has a well-conditioned basin;
* seed generation by sampling plane points and projecting them, mimicking
  the NVM sparse points + measurements VisualSFM would produce.

Quality metrics: a reconstructed patch's |distance to the surface| and the
angle between its normal and the true surface normal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from pais_mvs_tpu_torch.models.camera import CameraParams


@dataclass
class SyntheticScene:
    params: List[CameraParams]
    images: List[np.ndarray]          # uint8 [H, W, 3]
    seed_centers: np.ndarray          # [M, 3] ground-truth sparse points
    seed_cam_masks: np.ndarray        # [M, C] bool
    seed_img_points: np.ndarray       # [M, C, 2]
    seed_colors: np.ndarray           # [M, 3]
    plane_normal: np.ndarray          # [3] true surface normal (planar mode)
    plane_point: np.ndarray           # [3]
    amplitude: float                  # surface bump amplitude (0 for plane)

    def surface_distance(self, pts: np.ndarray) -> np.ndarray:
        """Unsigned distance of [N, 3] points to the ground-truth surface."""
        d = (pts - self.plane_point) @ self.plane_normal
        if self.amplitude:
            # height-field surface z = a * bumps(x, y): use vertical residual
            z = _bumps(pts[:, 0], pts[:, 1]) * self.amplitude
            return np.abs(pts[:, 2] - z)
        return np.abs(d)


def _lookat(center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->camera rotation with +z forward, y down-ish (image convention)."""
    z = target - center
    z = z / np.linalg.norm(z)
    up_hint = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up_hint, z)) > 0.99:
        up_hint = np.array([1.0, 0.0, 0.0])
    x = np.cross(up_hint, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z), w >= 0."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


_TEX_GRIDS = {}


def _texture(u: np.ndarray, v: np.ndarray, seed: int = 7) -> np.ndarray:
    """Multi-octave value noise over plane coords, range ~[40, 220]."""
    key = seed
    if key not in _TEX_GRIDS:
        rng = np.random.default_rng(seed)
        _TEX_GRIDS[key] = [rng.uniform(-1, 1, size=(33 * 2 ** o + 1,
                                                    33 * 2 ** o + 1))
                           for o in range(3)]
    total = np.zeros_like(u, dtype=np.float64)
    amp = 1.0
    for o, grid in enumerate(_TEX_GRIDS[key]):
        n = grid.shape[0] - 1
        # map [-1.6, 1.6] plane window onto the grid
        gu = np.clip((u + 1.6) / 3.2, 0, 1) * (n - 1)
        gv = np.clip((v + 1.6) / 3.2, 0, 1) * (n - 1)
        i0 = np.floor(gu).astype(int)
        j0 = np.floor(gv).astype(int)
        fu = gu - i0
        fv = gv - j0
        i1 = np.minimum(i0 + 1, n - 1)
        j1 = np.minimum(j0 + 1, n - 1)
        val = (grid[j0, i0] * (1 - fu) * (1 - fv) + grid[j0, i1] * fu * (1 - fv)
               + grid[j1, i0] * (1 - fu) * fv + grid[j1, i1] * fu * fv)
        total += amp * val
        amp *= 0.5
    total /= 1.75
    return 130.0 + 90.0 * total


def _bumps(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth unit-amplitude height field for the non-planar mode."""
    return np.sin(2.1 * x) * np.cos(1.7 * y)


def make_scene(num_cams: int = 5,
               width: int = 320, height: int = 240,
               num_seeds: int = 60,
               seed: int = 3,
               radius: float = 2.2,
               amplitude: float = 0.0,
               focal: float | None = None) -> SyntheticScene:
    """Render a textured plane (z = 0, normal +z) from an arc of cameras at
    z ~ -radius (so the surface normal faces the cameras at -z side... see
    note) — cameras are placed at negative z looking toward +z so that the
    camera optical axes are ~+z and the surface normal toward cameras is -z.
    """
    rng = np.random.default_rng(seed)
    f = focal or 1.1 * max(width, height)
    plane_n = np.array([0.0, 0.0, -1.0])   # toward the cameras
    plane_p = np.zeros(3)

    params: List[CameraParams] = []
    images: List[np.ndarray] = []
    Rs, centers = [], []
    for i in range(num_cams):
        ang = (i - (num_cams - 1) / 2) * (0.55 / max(num_cams - 1, 1) * 2)
        c = np.array([radius * np.sin(ang),
                      0.35 * np.sin(2.3 * ang),
                      -radius * np.cos(ang)])
        R = _lookat(c, np.zeros(3))
        Rs.append(R); centers.append(c)
        q = rotation_to_quaternion(R)
        params.append(CameraParams(
            file_name=f"synth{i:02d}.png",
            focal=np.array([f, f]),
            principal=np.array([-1.0, -1.0]),
            quaternion=q, center=c, radial_distortion=0.0))

    pp = np.array([width >> 1, height >> 1], dtype=np.float64)
    for i in range(num_cams):
        R, c = Rs[i], centers[i]
        xs, ys = np.meshgrid(np.arange(width), np.arange(height))
        dirs_cam = np.stack([(xs - pp[0]) / f, (ys - pp[1]) / f,
                             np.ones_like(xs, dtype=np.float64)], axis=-1)
        dirs = dirs_cam @ R                     # R^T applied row-wise
        if amplitude == 0.0:
            tz = -np.dot(plane_n, c - plane_p)
            denom = dirs @ plane_n
            t = tz / denom
            pts = c[None, None] + t[..., None] * dirs
        else:
            # few fixed-point iterations onto z = a*bumps(x, y)
            t = (0.0 - c[2]) / dirs[..., 2]
            for _ in range(12):
                pts = c[None, None] + t[..., None] * dirs
                zs = amplitude * _bumps(pts[..., 0], pts[..., 1])
                t = (zs - c[2]) / dirs[..., 2]
            pts = c[None, None] + t[..., None] * dirs
        tex = _texture(pts[..., 0], pts[..., 1])
        img = np.clip(np.round(tex), 1, 255).astype(np.uint8)
        images.append(np.stack([img, img, img], axis=-1))

    # sparse seeds on the surface, visible in every camera
    su = rng.uniform(-0.8, 0.8, size=num_seeds)
    sv = rng.uniform(-0.6, 0.6, size=num_seeds)
    if amplitude == 0.0:
        sz = np.zeros(num_seeds)
    else:
        sz = amplitude * _bumps(su, sv)
    pts3 = np.stack([su, sv, sz], axis=-1)

    C = num_cams
    masks = np.zeros((num_seeds, C), dtype=bool)
    ipts = np.zeros((num_seeds, C, 2))
    for i in range(C):
        R, c = Rs[i], centers[i]
        xc = (pts3 - c) @ R.T
        u = f * xc[:, 0] / xc[:, 2] + pp[0]
        v = f * xc[:, 1] / xc[:, 2] + pp[1]
        ok = (u >= 20) & (u < width - 20) & (v >= 20) & (v < height - 20)
        masks[:, i] = ok
        ipts[:, i, 0] = u
        ipts[:, i, 1] = v
    keep = masks.sum(axis=1) >= 3
    colors = np.full((int(keep.sum()), 3), 128.0)
    return SyntheticScene(
        params=params, images=images,
        seed_centers=pts3[keep], seed_cam_masks=masks[keep],
        seed_img_points=ipts[keep], seed_colors=colors,
        plane_normal=plane_n, plane_point=plane_p, amplitude=amplitude)
