"""A plain reference of the program's feature seeding: from the PNG files
and the calibrated cameras to seed tracks (camera sets, image points and
triangulated centres), in float64.

Plain PyTorch and numpy on the given device (the CPU in tests), computed
per camera and over blocks of camera pairs. It imports nothing of the
program; it follows the semantics the program's feature modules state
(``features/detect.py``, ``describe.py``, ``matching.py``, ``seeding.py``)
with other means: each blur is a product with the Gaussian's banded matrix
(edges replicated), the extrema and the edge test read shifted views, the
tracks are connected components by label propagation, the fundamental
matrices come from the projection matrices (F = [e']x P2 P1^+, the
upstream's route, featuremanager.cpp:249-288). ``dtype`` sets the
precision of the blur, the difference-of-Gaussians and the descriptors;
positions, matching and triangulation stay float64. The control runs it
in bfloat16.

Departures from SIFT (Lowe, IJCV 2004) and from the upstream's OpenCV
pipeline (TMVS/mvs/featuremanager.cpp:5-116), all the program's own:

  * detection: 4 octaves of 3 scales from sigma0 1.6 (the image taken at
    sigma 0.5, never doubled); an octave after the first runs only while
    the image is at least 32 pixels each way; a difference-of-Gaussians
    extremum is a sample at least as large (or as small) as its 26
    neighbours, ties included; contrast |D| > 0.01 on images scaled to
    [0, 1]; the edge test on the 2x2 Hessian at ratio 10; keypoints keep 8
    pixels from the octave's border; only the 192 strongest of an octave
    are kept (ties to the lower flat index over level, row, column); the
    sub-pixel offset is -g / h of the x and of the y second difference
    alone, clamped to +-0.5, with no offset in scale and no iteration;
  * orientation: one per keypoint, the centre of the first peak bin of a
    36-bin histogram of 19 x 19 samples at 0.75 sigma, weighted by a
    Gaussian of 5.4 samples, smoothed once by (1, 1, 1) / 3; no secondary
    peaks, no parabolic fit;
  * descriptor: 16 x 16 samples at 0.9 sigma on the rotated grid,
    gradients by central differences along the rotated axes, a Gaussian
    weight of 8 samples, each sample in its own 4 x 4 cell (no spatial
    interpolation) and linear between two of 8 orientation bins;
    normalised, clipped at 0.2, normalised again;
  * matching: every unordered pair of cameras, brute force over unit
    descriptors; a match is mutual, passes Lowe's ratio 0.85 on the L2
    distances, and lies within 3 pixels of its epipolar line; pairs with
    fewer than a quarter of the best pair's matches are dropped;
  * tracks: the union of the kept pairs' matches; a track keeps at least
    minCamNum cameras and no camera twice;
  * triangulation: the point closest to the track's rays (normal
    equations), not the upstream's Patch::reCentering.

``seed_gap`` and ``seed_px`` judge a program's seeds: the share of the
union of two sets of seeds that one alone holds (the same seed: the same
camera set and every image point within SEED_TOL pixels), and the 90th
percentile over the seeds' measurements of the distance from the
projection of the analytic surface point that the ray of the track's
first view meets.
"""

from __future__ import annotations

import math
import os
from typing import List, NamedTuple

import numpy as np
import torch

from benchmark.reference.photo import quat_to_R

F64 = torch.float64

SIGMA0 = 1.6
SCALES = 3
OCTAVES = 4
K_PER_OCTAVE = 192
CONTRAST = 0.01
EDGE_RATIO = 10.0
MARGIN = 8
ORI_GRID, ORI_STEP, ORI_BINS = 9, 0.75, 36
DESC_CELLS, DESC_SPC, DESC_BINS = 4, 4, 8
RATIO = 0.85
EPIPOLAR_PX = 3.0
MIN_PAIR_FRAC = 0.25
# two seeds are the same when they have the same cameras and every image
# point within this many pixels: the program's float32 sub-pixel offsets
# land at most 2.4e-4 px from the float64 ones (read on the tiny CPU rig of
# tests/test_torch_seedless.py), a flip of a discrete choice moves a point
# a pixel or more
SEED_TOL = 0.05
SEED_PX_Q = 0.9
PAIR_BLOCK = 64


class Camera(NamedTuple):
    R: np.ndarray        # world -> camera
    center: np.ndarray
    focal: float
    pp: np.ndarray       # principal point, pixels


class Seeds(NamedTuple):
    centers: np.ndarray      # [M, 3]
    masks: np.ndarray        # [M, C] bool
    points: np.ndarray       # [M, C, 2] pixels, top-left origin


def cameras(cams) -> List[Camera]:
    """The reference's cameras from the benchmark's scene cameras (the
    numbers the NVM gives the program; the principal point at the image
    centre, as NVM_V3 leaves it)."""
    return [Camera(quat_to_R(c.quaternion), np.asarray(c.center, float),
                   float(c.focal),
                   np.array([c.width // 2, c.height // 2], float))
            for c in cams]


def load_gray(scene_dir: str, cams) -> List[np.ndarray]:
    """Each camera's PNG as BT.601 grey levels (rounded, as OpenCV's
    imread(, 0)), float64 [H, W]."""
    from PIL import Image
    out = []
    for c in cams:
        img = np.asarray(Image.open(os.path.join(scene_dir, c.name)),
                         dtype=np.float64)
        if img.ndim == 3:
            img = np.round(0.299 * img[..., 0] + 0.587 * img[..., 1]
                           + 0.114 * img[..., 2])
        out.append(np.clip(img, 0, 255))
    return out


def gauss_taps(sigma: float) -> np.ndarray:
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def blur_matrix(n: int, sigma: float) -> np.ndarray:
    """[n, n]: the 1-D Gaussian blur of a length-n signal with its ends
    replicated, as a matrix."""
    k = gauss_taps(sigma)
    r = (len(k) - 1) // 2
    B = np.zeros((n, n))
    rows = np.repeat(np.arange(n), len(k))
    cols = np.clip(rows + np.tile(np.arange(-r, r + 1), n), 0, n - 1)
    np.add.at(B, (rows, cols), np.tile(k, n))
    return B


class Blur:
    """Separable Gaussian blurs of [H, W] images as two matrix products,
    the matrices built once per (size, sigma)."""

    def __init__(self, dtype, device):
        self.dtype, self.device, self.cache = dtype, device, {}

    def mat(self, n, sigma):
        key = (n, sigma)
        if key not in self.cache:
            self.cache[key] = torch.as_tensor(
                blur_matrix(n, sigma), device=self.device).to(self.dtype)
        return self.cache[key]

    def __call__(self, img, sigma):
        H, W = img.shape
        return self.mat(H, sigma) @ img @ self.mat(W, sigma).T


def shifted(x, dy, dx, fill):
    """x [..., H, W] moved so that out[y, x] = x[y + dy, x + dx], ``fill``
    outside."""
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys, yd = slice(max(dy, 0), H + min(dy, 0)), slice(max(-dy, 0),
                                                      H + min(-dy, 0))
    xs, xd = slice(max(dx, 0), W + min(dx, 0)), slice(max(-dx, 0),
                                                      W + min(-dx, 0))
    out[..., yd, xd] = x[..., ys, xs]
    return out


NEIGH = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def extrema(dogs, margin=MARGIN):
    """Score maps [S, H, W] of a DoG stack [S + 2, H, W]: |D| where D is
    an extremum of its 27 samples (ties included) that passes the
    contrast and edge tests inside the margin, else 0."""
    S = dogs.shape[0] - 2
    hi = torch.stack([shifted(dogs, dy, dx, -math.inf)
                      for dy, dx in NEIGH]).amax(0)
    lo = torch.stack([shifted(dogs, dy, dx, math.inf)
                      for dy, dx in NEIGH]).amin(0)
    H, W = dogs.shape[-2:]
    ys = torch.arange(H, device=dogs.device)[:, None]
    xs = torch.arange(W, device=dogs.device)[None, :]
    inside = ((xs >= margin) & (xs < W - margin) & (ys >= margin)
              & (ys < H - margin))
    out = []
    for s in range(1, S + 1):
        d = dogs[s]
        is_max = d >= torch.maximum(torch.maximum(hi[s - 1], hi[s]),
                                    hi[s + 1])
        is_min = d <= torch.minimum(torch.minimum(lo[s - 1], lo[s]),
                                    lo[s + 1])
        at = lambda dy, dx: shifted(d, dy, dx, 0.0)
        dxx = at(0, 1) + at(0, -1) - 2 * d
        dyy = at(1, 0) + at(-1, 0) - 2 * d
        dxy = 0.25 * (at(1, 1) + at(-1, -1) - at(1, -1) - at(-1, 1))
        tr, det = dxx + dyy, dxx * dyy - dxy * dxy
        flat = (det > 0) & (tr * tr * EDGE_RATIO
                            < (EDGE_RATIO + 1) ** 2 * det)
        ok = (is_max | is_min) & flat & (d.abs() > CONTRAST) & inside
        out.append(torch.where(ok, d.abs(), torch.zeros_like(d)))
    return torch.stack(out)


class Octave(NamedTuple):
    gauss: torch.Tensor      # [S + 3, H, W]
    xy: torch.Tensor         # [N, 2] octave pixels, float64
    sigma: torch.Tensor      # [N] octave scale, float64
    level: torch.Tensor      # [N] DoG level 0 .. S-1


def detect(gray: torch.Tensor, blur: Blur, dtype) -> List[Octave]:
    """The keypoints of one [H, W] grey image (0..255), per octave."""
    k = 2.0 ** (1.0 / SCALES)
    base = blur((gray / 255.0).to(dtype),
                math.sqrt(max(SIGMA0 ** 2 - 0.25, 0.01)))
    out = []
    for o in range(OCTAVES):
        H, W = base.shape
        if o > 0 and (H < 32 or W < 32):
            break
        gs = [base]
        for i in range(1, SCALES + 3):
            sp, sn = SIGMA0 * k ** (i - 1), SIGMA0 * k ** i
            gs.append(blur(gs[-1], math.sqrt(sn * sn - sp * sp)))
        gauss = torch.stack(gs)
        dogs = gauss[1:] - gauss[:-1]
        score = extrema(dogs).reshape(-1)
        vals, idx = torch.sort(score, descending=True, stable=True)
        keep = vals[:K_PER_OCTAVE] > 0
        idx = idx[:K_PER_OCTAVE][keep]
        lvl, yy, xx = idx // (H * W), idx % (H * W) // W, idx % W
        d = lambda dy, dx: dogs[lvl + 1, (yy + dy).clamp(0, H - 1),
                                (xx + dx).clamp(0, W - 1)].to(F64)
        c = d(0, 0)

        def offset(g, h):
            h = torch.where(h.abs() > 1e-8, h, torch.ones_like(h))
            return (-g / h).clamp(-0.5, 0.5)

        ox = offset(0.5 * (d(0, 1) - d(0, -1)), d(0, 1) + d(0, -1) - 2 * c)
        oy = offset(0.5 * (d(1, 0) - d(-1, 0)), d(1, 0) + d(-1, 0) - 2 * c)
        xy = torch.stack([xx.to(F64) + ox, yy.to(F64) + oy], -1)
        sigma = SIGMA0 * k ** (lvl.to(F64) + 1)
        out.append(Octave(gauss, xy, sigma, lvl))
        base = gs[SCALES][::2, ::2]
    return out


def bilinear(stack, lv, xy):
    """Clamped bilinear samples of image ``lv[k]`` of stack [L, H, W] at
    xy [N, ..., 2] (x, y)."""
    H, W = stack.shape[-2:]
    x = xy[..., 0].clamp(0.0, W - 1.001)
    y = xy[..., 1].clamp(0.0, H - 1.001)
    x0, y0 = x.floor().long(), y.floor().long()
    fx, fy = (x - x0).to(stack.dtype), (y - y0).to(stack.dtype)
    lv = lv.reshape((-1,) + (1,) * (x.dim() - 1))
    g = lambda dy, dx: stack[lv, y0 + dy, x0 + dx]
    return (g(0, 0) * (1 - fx) * (1 - fy) + g(0, 1) * fx * (1 - fy)
            + g(1, 0) * (1 - fx) * fy + g(1, 1) * fx * fy)


def histogram(bins, weights, n):
    """[N, n] sums of weights [N, S] by bins [N, S]."""
    onehot = bins[..., None] == torch.arange(n, device=bins.device)
    return torch.where(onehot, weights[..., None],
                       torch.zeros((), dtype=weights.dtype,
                                   device=weights.device)).sum(-2)


def grid(n, offset, device):
    ax = torch.arange(n, dtype=F64, device=device) + offset
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    return gx, gy


def describe(octv: Octave) -> torch.Tensor:
    """[N, 128] descriptors of one octave's keypoints, in the octave's
    precision."""
    N = octv.xy.shape[0]
    dt = octv.gauss.dtype
    if N == 0:
        return torch.zeros((0, DESC_CELLS ** 2 * DESC_BINS), dtype=dt,
                           device=octv.xy.device)
    lv = (octv.level + 1).clamp(0, octv.gauss.shape[0] - 1)
    sample = lambda pts: bilinear(octv.gauss, lv, pts)
    xy, sig = octv.xy, octv.sigma
    dev = xy.device

    # orientation: the first peak of the smoothed 36-bin histogram
    gx, gy = grid(2 * ORI_GRID + 1, -ORI_GRID, dev)
    gx, gy = gx * ORI_STEP, gy * ORI_STEP
    pts = xy[:, None, None, :] + sig[:, None, None, None] * torch.stack(
        [gx, gy], -1)
    h = (0.5 * sig * ORI_STEP)[:, None, None]
    z = torch.zeros_like(h)
    dx = sample(pts + torch.stack([h, z], -1)) - sample(
        pts - torch.stack([h, z], -1))
    dy = sample(pts + torch.stack([z, h], -1)) - sample(
        pts - torch.stack([z, h], -1))
    w = torch.exp(-(gx * gx + gy * gy) / (2.0 * (0.6 * ORI_GRID) ** 2))
    mag = torch.sqrt(dx * dx + dy * dy) * w.to(dt)
    theta = torch.atan2(dy, dx)
    bins = ((theta + math.pi) / (2 * math.pi) * ORI_BINS).to(
        torch.int64).clamp(0, ORI_BINS - 1)
    hist = histogram(bins.reshape(N, -1), mag.reshape(N, -1), ORI_BINS)
    hist = (hist.roll(1, -1) + hist + hist.roll(-1, -1)) / 3.0
    ori = ((hist.argmax(-1).to(F64) + 0.5) / ORI_BINS * 2 * math.pi
           - math.pi)

    # the 4 x 4 x 8 descriptor on the rotated 16 x 16 grid
    n = DESC_CELLS * DESC_SPC
    half = n / 2.0
    gx, gy = grid(n, -half + 0.5, dev)
    sp = (0.9 * sig)[:, None, None]
    ca, sa = torch.cos(ori)[:, None, None], torch.sin(ori)[:, None, None]
    pts = xy[:, None, None, :] + torch.stack(
        [(ca * gx - sa * gy) * sp, (sa * gx + ca * gy) * sp], -1)
    du = torch.stack([ca, sa], -1) * (0.5 * sp)[..., None]
    dv = torch.stack([-sa, ca], -1) * (0.5 * sp)[..., None]
    dxr = sample(pts + du) - sample(pts - du)
    dyr = sample(pts + dv) - sample(pts - dv)
    w = torch.exp(-(gx * gx + gy * gy) / (2.0 * (0.5 * n) ** 2))
    mag = (torch.sqrt(dxr * dxr + dyr * dyr) * w.to(dt)).reshape(N, -1)
    binf = ((torch.atan2(dyr, dxr) + math.pi) / (2 * math.pi)
            * DESC_BINS).reshape(N, -1)
    fl = binf.floor()
    b0 = fl.to(torch.int64) % DESC_BINS
    b1 = (b0 + 1) % DESC_BINS
    f = binf - fl
    cell = (((gy + half - 0.5) // DESC_SPC) * DESC_CELLS
            + (gx + half - 0.5) // DESC_SPC).to(torch.int64).reshape(-1)
    nb = DESC_CELLS * DESC_CELLS * DESC_BINS
    desc = (histogram(cell * DESC_BINS + b0, mag * (1 - f), nb)
            + histogram(cell * DESC_BINS + b1, mag * f, nb))
    unit = lambda v: v / v.norm(dim=-1, keepdim=True).clamp_min(
        torch.finfo(v.dtype).tiny)
    return unit(unit(desc).clamp(max=0.2))


def features(gray: np.ndarray, blur: Blur, dtype, device):
    """(xy [N, 2] level-0 pixels float64, descriptors [N, 128] float64)
    of one camera's grey image."""
    g = torch.as_tensor(gray, dtype=F64, device=device)
    xys, descs = [], []
    for o, octv in enumerate(detect(g, blur, dtype)):
        xys.append(octv.xy * 2.0 ** o)
        descs.append(describe(octv).to(F64))
    return torch.cat(xys), torch.cat(descs)


def fundamental(a: Camera, b: Camera) -> np.ndarray:
    """F with x_b^T F x_a = 0: [e_b]x P_b P_a^+ from the projection
    matrices."""
    P = lambda c: np.array([[c.focal, 0, c.pp[0]], [0, c.focal, c.pp[1]],
                            [0, 0, 1.0]]) @ np.hstack(
        [c.R, (-c.R @ c.center)[:, None]])
    Pa, Pb = P(a), P(b)
    e = Pb @ np.append(a.center, 1.0)
    ex = np.array([[0, -e[2], e[1]], [e[2], 0, -e[0]], [-e[1], e[0], 0.0]])
    return ex @ Pb @ np.linalg.pinv(Pa)


def match(xys, descs, cams, device):
    """Every unordered pair's matches {(i, j): (kp_i [m], kp_j [m])}
    after the pairs' pruning, computed over blocks of pairs."""
    C = len(xys)
    Kmax = max(1, max(len(x) for x in xys))
    D = torch.zeros((C, Kmax, descs[0].shape[1]), dtype=F64, device=device)
    X = torch.zeros((C, Kmax, 2), dtype=F64, device=device)
    valid = torch.zeros((C, Kmax), dtype=torch.bool, device=device)
    for c in range(C):
        n = len(xys[c])
        D[c, :n], X[c, :n], valid[c, :n] = descs[c], xys[c], True
    pairs = [(i, j) for i in range(C) for j in range(i + 1, C)]
    raw = {}
    ar = torch.arange(Kmax, device=device)
    for s in range(0, len(pairs), PAIR_BLOCK):
        blk = pairs[s:s + PAIR_BLOCK]
        I = torch.as_tensor([p[0] for p in blk], device=device)
        J = torch.as_tensor([p[1] for p in blk], device=device)
        both = valid[I][:, :, None] & valid[J][:, None, :]
        sim = torch.where(both, D[I] @ D[J].transpose(1, 2),
                          torch.full((), -2.0, dtype=F64, device=device))
        best, s1 = sim.argmax(2), sim.amax(2)
        rows = torch.arange(len(blk), device=device)[:, None]
        s2 = sim.scatter(2, best[..., None], -2.0).amax(2)
        dist = lambda v: torch.sqrt((2.0 - 2.0 * v).clamp_min(0.0))
        mutual = sim.argmax(1)[rows, best] == ar
        F = torch.as_tensor(np.stack([fundamental(cams[i], cams[j])
                                      for i, j in blk]), device=device)
        p1 = torch.cat([X[I], torch.ones_like(X[I][..., :1])], -1)
        line = p1 @ F.transpose(1, 2)               # epipolar lines in j
        p2 = X[J][rows, best]
        num = (line[..., 0] * p2[..., 0] + line[..., 1] * p2[..., 1]
               + line[..., 2]).abs()
        den = torch.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2)
        epi = num / torch.where(den > 0, den, torch.ones_like(den))
        good = (valid[I] & valid[J][rows, best] & mutual
                & (dist(s1) <= RATIO * dist(s2)) & (epi <= EPIPOLAR_PX)
                & (s1 > -2.0))
        good, best = good.cpu().numpy(), best.cpu().numpy()
        for k, p in enumerate(blk):
            i1 = np.nonzero(good[k])[0]
            raw[p] = (i1, best[k, i1])
    if not raw:
        return {}
    top = max(len(v[0]) for v in raw.values())
    return {p: v for p, v in raw.items() if len(v[0]) >= top * MIN_PAIR_FRAC}


def tracks(pairs, Kmax: int, min_cams: int):
    """Connected components of the matches' graph over (camera,
    keypoint) nodes, by label propagation: [(cams [n], kps [n])] of the
    components with at least ``min_cams`` cameras and no camera twice,
    in the order of their smallest node."""
    if not pairs:
        return []
    a = np.concatenate([i * Kmax + v[0] for (i, j), v in pairs.items()])
    b = np.concatenate([j * Kmax + v[1] for (i, j), v in pairs.items()])
    nodes, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    ea, eb = inv[:len(a)], inv[len(a):]
    label = np.arange(len(nodes))
    while True:
        m = np.minimum(label[ea], label[eb])
        new = label.copy()
        np.minimum.at(new, ea, m)
        np.minimum.at(new, eb, m)
        new = new[new]
        if np.array_equal(new, label):
            break
        label = new
    cam, kp = nodes // Kmax, nodes % Kmax
    out = []
    order = np.argsort(label, kind="stable")
    starts = np.flatnonzero(np.diff(label[order], prepend=-1))
    for g in np.split(order, starts[1:]):
        cs = cam[g]
        if len(np.unique(cs)) == len(cs) and len(cs) >= min_cams:
            out.append((cs, kp[g]))
    return out


def triangulate(masks, points, cams) -> np.ndarray:
    """The point closest to each track's rays [M, 3] (normal equations
    sum (I - d d^T) x = sum (I - d d^T) c over its cameras)."""
    M = len(masks)
    A, b = np.zeros((M, 3, 3)), np.zeros((M, 3))
    for c, cam in enumerate(cams):
        uv = points[:, c]
        d = np.stack([(uv[:, 0] - cam.pp[0]) / cam.focal,
                      (uv[:, 1] - cam.pp[1]) / cam.focal,
                      np.ones(M)], -1) @ cam.R
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        P = (np.eye(3) - d[:, :, None] * d[:, None, :]) * masks[:, c,
                                                                 None, None]
        A += P
        b += P @ cam.center
    return np.einsum("mij,mj->mi", np.linalg.pinv(A), b)


def seeds(grays, cams, min_cams: int, device, dtype=F64) -> Seeds:
    """The seeds of the reference's pipeline: detection and description
    per camera in ``dtype``, matching over blocks of pairs, tracks,
    triangulation."""
    blur = Blur(dtype, device)
    xys, descs = [], []
    for g in grays:
        xy, desc = features(g, blur, dtype, device)
        xys.append(xy)
        descs.append(desc)
    del blur
    C = len(cams)
    pairs = match(xys, descs, cams, device)
    Kmax = max(1, max(len(x) for x in xys))
    pts = [x.cpu().numpy() for x in xys]
    found = tracks(pairs, Kmax, min_cams)
    M = len(found)
    masks = np.zeros((M, C), dtype=bool)
    points = np.zeros((M, C, 2))
    for t, (cs, ks) in enumerate(found):
        masks[t, cs] = True
        points[t, cs] = np.stack([pts[c][k] for c, k in zip(cs, ks)])
    centers = triangulate(masks, points, cams) if M else np.zeros((0, 3))
    good = np.all(np.isfinite(centers), -1)
    return Seeds(centers[good], masks[good], points[good])


def same_seeds(a: Seeds, b: Seeds, tol: float = SEED_TOL) -> int:
    """How many seeds of ``a`` have their own seed in ``b``: the same
    camera set and every image point within ``tol`` pixels (one to
    one)."""
    by_set = {}
    for k in range(len(b.masks)):
        by_set.setdefault(b.masks[k].tobytes(), []).append(k)
    taken, same = set(), 0
    for k in range(len(a.masks)):
        m = a.masks[k]
        for r in by_set.get(m.tobytes(), []):
            if r in taken:
                continue
            if np.abs(a.points[k][m] - b.points[r][m]).max() <= tol:
                taken.add(r)
                same += 1
                break
    return same


def seed_gap(prog: Seeds, ref: Seeds, tol: float = SEED_TOL) -> float:
    """The share of the union of the two sets of seeds that only one of
    them holds."""
    same = same_seeds(prog, ref, tol)
    union = len(prog.masks) + len(ref.masks) - same
    return (union - same) / union if union else 0.0


def seed_errors(s: Seeds, cams, surface) -> np.ndarray:
    """The distances in pixels, over the seeds' measurements in the views
    after their first, between a measurement and the projection of the
    surface point that the first view's ray through its measurement meets
    (inf where the ray misses)."""
    M = len(s.masks)
    if M == 0:
        return np.zeros(0)
    first = s.masks.argmax(1)
    o = np.stack([cams[c].center for c in first])
    uv = s.points[np.arange(M), first]
    d = np.stack([np.array([(u - cams[c].pp[0]) / cams[c].focal,
                            (v - cams[c].pp[1]) / cams[c].focal, 1.0])
                  @ cams[c].R for c, (u, v) in zip(first, uv)])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t, miss = surface.cast(o, d)
    X = o + np.where(miss[:, None] == 0, t[:, None], np.nan) * d
    errs = [np.zeros(0)]
    for c, cam in enumerate(cams):
        sel = s.masks[:, c] & (first != c)
        if not sel.any():
            continue
        xc = (X[sel] - cam.center) @ cam.R.T
        proj = cam.focal * xc[:, :2] / xc[:, 2:3] + cam.pp
        e = np.linalg.norm(proj - s.points[sel, c], axis=-1)
        errs.append(np.where(np.isfinite(e), e, np.inf))
    return np.sort(np.concatenate(errs))


def seed_px(s: Seeds, cams, surface, q: float = SEED_PX_Q) -> float:
    """The ``q`` quantile (nearest rank) of ``seed_errors``: a miss counts
    as infinitely far; NaN without measurements."""
    e = seed_errors(s, cams, surface)
    if len(e) == 0:
        return math.nan
    return float(e[max(int(math.ceil(q * len(e))) - 1, 0)])
