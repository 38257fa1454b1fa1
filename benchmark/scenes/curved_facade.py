"""A value-noise-textured curved height field seen from an arc of cameras,
rendered on the card.

A PyTorch copy of the math of ``pais_mvs_tpu_torch/data/synthetic.py::
make_scene`` at commit 04b33df (the curved mode, ``amplitude > 0``): the
same camera arc, the same height field z = a sin(2.1x) cos(1.7y), the
same three-octave value noise and the same seed sampling. Changes: the
configuration's ``scene_seed`` (not the run's seed, so that every run does
the same work) draws the noise lattice and the seed points with a
``torch.Generator`` on the rendering device, in a few large calls, and the
images are rendered in float64 on that device. Nothing of the
program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.scenes import Camera, Scene

RADIUS = 2.2          # camera distance from the origin
SPREAD = 0.55         # half-angle of the arc (radians)
FIXED_POINT_STEPS = 12


def lookat(center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World-to-camera rotation with +z forward."""
    z = target - center
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up, z)) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=0)


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z), w >= 0."""
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def bumps(x, y):
    lib = torch if torch.is_tensor(x) else np
    return lib.sin(2.1 * x) * lib.cos(1.7 * y)


class HeightField:
    """z = amplitude * bumps(x, y)."""

    def __init__(self, amplitude: float):
        self.amplitude = amplitude

    def cast(self, o, dirs, steps: int = 60):
        """Hit of rays ``o + t dirs`` by fixed-point steps on z; returns
        (t [N], kind [N]: 0 hit)."""
        o = np.broadcast_to(np.asarray(o, float), np.shape(dirs))
        dirs = np.asarray(dirs, float)
        t = -o[:, 2] / dirs[:, 2]
        for _ in range(steps):
            p = o + t[:, None] * dirs
            t = (self.amplitude * bumps(p[:, 0], p[:, 1]) - o[:, 2]) \
                / dirs[:, 2]
        return t, np.zeros(len(t), dtype=np.int32)

    def distance(self, X) -> np.ndarray:
        """Vertical residual |z - a bumps(x, y)| (the surface is gentle)."""
        X = np.atleast_2d(np.asarray(X, float))
        return np.abs(X[:, 2] - self.amplitude * bumps(X[:, 0], X[:, 1]))


def texture(u, v, grids):
    """Multi-octave value noise over plane coordinates, range ~[40, 220]."""
    total = torch.zeros_like(u)
    amp = 1.0
    for grid in grids:
        n = grid.shape[0] - 1
        gu = torch.clamp((u + 1.6) / 3.2, 0, 1) * (n - 1)
        gv = torch.clamp((v + 1.6) / 3.2, 0, 1) * (n - 1)
        i0, j0 = torch.floor(gu).long(), torch.floor(gv).long()
        fu, fv = gu - i0, gv - j0
        i1, j1 = torch.clamp(i0 + 1, max=n - 1), torch.clamp(j0 + 1, max=n - 1)
        total += amp * (grid[j0, i0] * (1 - fu) * (1 - fv)
                        + grid[j0, i1] * fu * (1 - fv)
                        + grid[j1, i0] * (1 - fu) * fv
                        + grid[j1, i1] * fu * fv)
        amp *= 0.5
    return 130.0 + 90.0 * total / 1.75


def render(cfg: dict, seed: int, device=None) -> Scene:
    W, H = int(cfg["width"]), int(cfg["height"])
    C, num_seeds = int(cfg["cameras"]), int(cfg["seeds"])
    amplitude = float(cfg["amplitude"])
    dev = torch.device(device or "cpu")
    f64 = torch.float64
    gen = torch.Generator(dev).manual_seed(int(cfg["scene_seed"]))
    f = 1.1 * max(W, H)
    grids = [torch.rand((33 * 2 ** o + 1,) * 2, generator=gen, dtype=f64,
                        device=dev) * 2 - 1 for o in range(3)]
    pp = np.array([W >> 1, H >> 1], dtype=np.float64)
    Rs, centers, cams, images = [], [], [], []
    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    d_cam = torch.stack([(xs - pp[0]) / f, (ys - pp[1]) / f,
                         torch.ones_like(xs)], -1)
    for i in range(C):
        ang = (i - (C - 1) / 2) * (SPREAD / max(C - 1, 1) * 2)
        c = np.array([RADIUS * math.sin(ang), 0.35 * math.sin(2.3 * ang),
                      -RADIUS * math.cos(ang)])
        R = lookat(c, np.zeros(3))
        Rs.append(R)
        centers.append(c)
        dirs = d_cam @ torch.as_tensor(R, dtype=f64, device=dev)
        ct = torch.as_tensor(c, dtype=f64, device=dev)
        t = -ct[2] / dirs[..., 2]
        for _ in range(FIXED_POINT_STEPS):
            p = ct + t[..., None] * dirs
            t = (amplitude * bumps(p[..., 0], p[..., 1]) - ct[2]) \
                / dirs[..., 2]
        p = ct + t[..., None] * dirs
        img = torch.clamp(torch.round(texture(p[..., 0], p[..., 1], grids)),
                          1, 255).to(torch.uint8)
        images.append(img[..., None].expand(H, W, 3).cpu().numpy().copy())
        cams.append(Camera(name=f"view{i:02d}.png", focal=f,
                           quaternion=rotation_to_quaternion(R), center=c,
                           radial=0.0, width=W, height=H))
    del d_cam, xs, ys, dirs, p, t, img, grids

    uv = torch.rand((num_seeds, 2), generator=gen, dtype=f64,
                    device=dev).cpu().numpy()
    su, sv = uv[:, 0] * 1.6 - 0.8, uv[:, 1] * 1.2 - 0.6
    pts = np.stack([su, sv, amplitude * bumps(su, sv)], -1)
    masks = np.zeros((num_seeds, C), dtype=bool)
    ipts = np.zeros((num_seeds, C, 2))
    for i in range(C):
        xc = (pts - centers[i]) @ Rs[i].T
        u = f * xc[:, 0] / xc[:, 2] + pp[0]
        v = f * xc[:, 1] / xc[:, 2] + pp[1]
        masks[:, i] = (u >= 20) & (u < W - 20) & (v >= 20) & (v < H - 20)
        ipts[:, i, 0], ipts[:, i, 1] = u, v
    keep = np.nonzero(masks.sum(axis=1) >= 3)[0]
    return Scene(cameras=cams, images=images, seed_points=pts[keep],
                 seed_masks=masks[keep], seed_pixels=ipts[keep],
                 surface=HeightField(amplitude))
