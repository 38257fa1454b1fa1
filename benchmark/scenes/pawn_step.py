"""The pawn rig looking at a photo-textured stepped plane.

Frozen copy of ``pais_mvs_tpu_torch/data/realistic.py`` at commit 04b33df
(``make_realistic_scene`` with ``distort=False``, ``StepSurface``), kept
here so that the benchmark's scene does not move when the program's data
module does. Changes: the size comes from the configuration (the five
real cameras' focals scale with the width), and the configuration's
``scene_seed`` (not the run's seed) draws the photometric jitter and the
seed points, so that every run does the same work. NumPy only; nothing of
the program is imported.

The five NVM rows are the upstream project's pawn example
(adahbingee/pais-mvs README.md:68-72): name, focal, quaternion wxyz,
centre xyz, radial distortion.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.scenes import Camera, Scene

PAWN_CAMERAS = [
    ("pawn0013.jpg", 614.095397949,
     (0.705410371683, 0.160690743319, 0.671401589359, 0.160605237544),
     (-0.556085150075, 0.0481223921551, -0.00781510757143), -0.199289312888),
    ("pawn0010.jpg", 616.175537109,
     (0.90353903514, 0.221746421078, 0.3576944596, 0.0806247263945),
     (-0.880841878288, 0.0327703491031, -0.684201024844), -0.209314043486),
    ("pawn0011.jpg", 612.03302002,
     (0.85241383667, 0.2037593266, 0.469072019941, 0.108830220502),
     (-0.71971232163, 0.0433857776889, -0.492035476323), -0.207263977174),
    ("pawn0012.jpg", 611.360473633,
     (0.786507583571, 0.183363764635, 0.573952646995, 0.135504187104),
     (-0.608685012281, 0.0487066227347, -0.263440114899), -0.203210786458),
    ("pawn0014.jpg", 617.585876465,
     (0.611485687162, 0.135944898976, 0.757586998462, 0.183482834469),
     (-0.572254659063, 0.0434025057556, 0.255716172724), -0.198563271584),
]
BASE_WIDTH = 640
PHOTO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "grace_hopper.jpg")


def quat_to_R(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, float) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class StepSurface:
    """Plane through p0 (frame e1, e2, n) with a raised rectangular step of
    half-extents (a, b) and height h; plane half-extents (U, V)."""

    def __init__(self, p0, e1, e2, n, U, V, a, b, h):
        self.p0, self.e1, self.e2, self.n = p0, e1, e2, n
        self.U, self.V, self.a, self.b, self.h = U, V, a, b, h

    def uvw(self, X):
        d = np.asarray(X) - self.p0
        return d @ self.e1, d @ self.e2, d @ self.n

    def cast(self, o, dirs):
        """Nearest hit of rays ``o + t dirs`` (o [3] or [N, 3], dirs
        [N, 3]). Returns (t [N], kind [N]: -1 miss, 0 plane, 1 top, 2..5
        sides)."""
        dirs = np.asarray(dirs, float)
        N = len(dirs)
        tbest = np.full(N, np.inf)
        kind = np.full(N, -1, dtype=np.int32)
        du, dv, dw = dirs @ self.e1, dirs @ self.e2, dirs @ self.n
        ou, ov, ow = self.uvw(o)

        def consider(t, ok, k):
            nonlocal tbest, kind
            ok = ok & (t > 1e-9) & (t < tbest)
            tbest = np.where(ok, t, tbest)
            kind = np.where(ok, k, kind)

        with np.errstate(divide="ignore", invalid="ignore"):
            t = -ow / dw
            u, v = ou + t * du, ov + t * dv
            consider(t, (np.abs(u) <= self.U) & (np.abs(v) <= self.V)
                     & ~((np.abs(u) < self.a) & (np.abs(v) < self.b))
                     & (dw != 0), 0)
            t = (self.h - ow) / dw
            u, v = ou + t * du, ov + t * dv
            consider(t, (np.abs(u) <= self.a) & (np.abs(v) <= self.b)
                     & (dw != 0), 1)
            for i, sgn in enumerate((1, -1)):
                t = (sgn * self.a - ou) / du
                v, w = ov + t * dv, ow + t * dw
                consider(t, (np.abs(v) <= self.b) & (w >= 0) & (w <= self.h)
                         & (du != 0), 2 + i)
            for i, sgn in enumerate((1, -1)):
                t = (sgn * self.b - ov) / dv
                u, w = ou + t * du, ow + t * dw
                consider(t, (np.abs(u) <= self.a) & (w >= 0) & (w <= self.h)
                         & (dv != 0), 4 + i)
        return tbest, kind

    def distance(self, X) -> np.ndarray:
        """Unsigned distance of points [N, 3] to the surface."""
        X = np.atleast_2d(np.asarray(X, float))
        u, v, w = self.uvw(X)

        def rect(uu, vv, ww, a, b):
            du = np.maximum(np.abs(uu) - a, 0.0)
            dv = np.maximum(np.abs(vv) - b, 0.0)
            return np.sqrt(du * du + dv * dv + ww * ww)

        inside = (np.abs(u) < self.a) & (np.abs(v) < self.b)
        lateral = np.where(inside, np.minimum(self.a - np.abs(u),
                                              self.b - np.abs(v)), 0.0)
        cands = [np.where(inside, np.sqrt(lateral ** 2 + w ** 2),
                          rect(u, v, w, self.U, self.V)),
                 rect(u, v, w - self.h, self.a, self.b)]
        hw = self.h / 2.0
        cands += [rect(v, w - hw, u - self.a, self.b, hw),
                  rect(v, w - hw, u + self.a, self.b, hw),
                  rect(u, w - hw, v - self.b, self.a, hw),
                  rect(u, w - hw, v + self.b, self.a, hw)]
        return np.min(np.stack(cands), axis=0)


def load_photo() -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(PHOTO).convert("RGB"))


def render(cfg: dict, seed: int, device=None) -> Scene:
    """The scene of configuration ``cfg``: images, cameras, seed points and
    the analytic surface. ``seed`` and ``device`` are unused (NumPy)."""
    W, H = int(cfg["width"]), int(cfg["height"])
    num_seeds = int(cfg["seeds"])
    scale = W / BASE_WIDTH
    rng = np.random.default_rng(int(cfg["scene_seed"]))
    photo = load_photo().astype(np.float64)

    Rs = [quat_to_R(q) for _, _, q, _, _ in PAWN_CAMERAS]
    centers = np.array([c for _, _, _, c, _ in PAWN_CAMERAS])
    focals = [f for _, f, _, _, _ in PAWN_CAMERAS]
    opticals = np.array([R.T @ np.array([0, 0, 1.0]) for R in Rs])

    # the surface sits at the least-squares meeting point of the axes
    A, b = np.zeros((3, 3)), np.zeros(3)
    for c, d in zip(centers, opticals):
        P = np.eye(3) - np.outer(d, d)
        A += P
        b += P @ c
    target = np.linalg.pinv(A) @ b
    depth = float(np.mean(np.linalg.norm(centers - target, axis=1)))
    n = -opticals.mean(axis=0)
    n /= np.linalg.norm(n)
    e1 = np.cross(n, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    half = depth * (BASE_WIDTH / 2) / float(np.mean(focals)) * 1.15
    surf = StepSurface(p0=target, e1=e1, e2=e2, n=n, U=half, V=half * 0.8,
                       a=half * 0.35, b=half * 0.3, h=depth * 0.06)

    def tex(u, v, w, kind):
        ph, pw = photo.shape[:2]
        su = np.where(kind == 1, u + 0.17 * surf.U, u)
        sv = np.where(kind == 1, v - 0.13 * surf.V, v)
        su = np.where(kind >= 2, v + w, su)
        sv = np.where(kind >= 2, u - 2.0 * w, sv)
        px = np.clip((su / surf.U * 0.5 + 0.5) * (pw - 2), 0, pw - 2)
        py = np.clip((sv / surf.V * 0.5 + 0.5) * (ph - 2), 0, ph - 2)
        x0, y0 = np.floor(px).astype(int), np.floor(py).astype(int)
        fx, fy = (px - x0)[..., None], (py - y0)[..., None]
        return (photo[y0, x0] * (1 - fx) * (1 - fy)
                + photo[y0, x0 + 1] * fx * (1 - fy)
                + photo[y0 + 1, x0] * (1 - fx) * fy
                + photo[y0 + 1, x0 + 1] * fx * fy)

    cams, images = [], []
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pp = np.array([W >> 1, H >> 1], dtype=np.float64)
    for i, (name, f, q, c, r_dist) in enumerate(PAWN_CAMERAS):
        f = f * scale
        d_cam = np.stack([(xs.ravel() - pp[0]) / f, (ys.ravel() - pp[1]) / f,
                          np.ones(W * H)], axis=-1)
        dirs = d_cam @ Rs[i]
        t, kind = surf.cast(centers[i], dirs)
        hit = kind >= 0
        X = centers[i][None] + np.where(hit, t, 0.0)[:, None] * dirs
        u, v, w = surf.uvw(X)
        gain = 1.0 + rng.uniform(-0.06, 0.06)
        bias = rng.uniform(-4.0, 4.0)
        col = np.clip(tex(u, v, w, kind) * gain + bias, 1.0, 255.0)
        img = np.zeros((H * W, 3))
        img[hit] = col[hit]
        images.append(img.reshape(H, W, 3).astype(np.uint8))
        cams.append(Camera(name=os.path.splitext(name)[0] + ".png", focal=f,
                           quaternion=np.asarray(q, float),
                           center=np.asarray(c, float), radial=r_dist,
                           width=W, height=H))

    # seeds on the visible surface, with occlusion-aware visibility
    su = rng.uniform(-surf.U * 0.9, surf.U * 0.9, num_seeds * 3)
    sv = rng.uniform(-surf.V * 0.9, surf.V * 0.9, num_seeds * 3)
    on_top = (np.abs(su) < surf.a) & (np.abs(sv) < surf.b)
    pts = (surf.p0[None] + su[:, None] * surf.e1[None]
           + sv[:, None] * surf.e2[None]
           + np.where(on_top, surf.h, 0.0)[:, None] * surf.n[None])
    masks = np.zeros((len(pts), len(cams)), dtype=bool)
    ipts = np.zeros((len(pts), len(cams), 2))
    for ci in range(len(cams)):
        R, f = Rs[ci], focals[ci] * scale
        xc = (pts - centers[ci]) @ R.T
        with np.errstate(divide="ignore", invalid="ignore"):
            xy = xc[:, :2] / xc[:, 2:3] * f + pp
        inb = ((xy[:, 0] >= 8) & (xy[:, 0] < W - 8) & (xy[:, 1] >= 8)
               & (xy[:, 1] < H - 8) & (xc[:, 2] > 0))
        t, kind = surf.cast(centers[ci], pts - centers[ci])
        masks[:, ci] = inb & (np.abs(t - 1.0) < 1e-3) & (kind >= 0)
        ipts[:, ci] = xy
    keep = np.nonzero(masks.sum(axis=1) >= 3)[0][:num_seeds]
    return Scene(cameras=cams, images=images, seed_points=pts[keep],
                 seed_masks=masks[keep], seed_pixels=ipts[keep],
                 surface=surf)
