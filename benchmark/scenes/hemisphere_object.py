"""A closed, value-noise-textured object on a black background, seen by
look-at cameras spread evenly over the upper hemisphere around it: the
shape of the Middlebury multi-view "temple" set (Seitz et al., CVPR 2006),
whose 312 views of one plaster object were taken on a hemisphere.

The object is star-shaped about the origin: its surface is r(d) =
RADIUS (1 + BUMP bumps(d)) for unit directions d, bumps a smooth
low-frequency field in [-1, 1]. Its texture is three octaves of value
noise over d (so it has no seam), in [40, 220] grey levels and never 0;
the background is 0 but for the silhouette's edge, blurred by one pixel as
a lens blurs it (``rim_blur``). A hemisphere of views puts every point of
the surface near the silhouette of some of them, and the program's runtime
filter rejects a patch whose centre falls on a background pixel of any
view: with a hard edge a refined centre a fraction of a pixel outside the
rim lands on 0 in some view, and nearly every patch is rejected. The
cameras lie on a
Fibonacci lattice of the hemisphere, between ELEVATION degrees, at the
distance where the object's bounding sphere spans FILL of the frame
height; ``render`` asserts that the object lies whole inside every frame,
since the program's runtime filter drops any patch whose centre leaves
one. Rays are cast in float64 on the rendering device: bracketed by
MARCH steps inside the bounding sphere, then bisected.

The configuration's ``scene_seed`` (not the run's seed, so that every run
does the same work) draws the noise lattice and the seed points with a
``torch.Generator``. Each seed is measured in the views that see it: the
point is the first hit of the camera's ray, lies MARGIN pixels inside the
frame, and its surface normal faces the camera within the cone that the
program's visible-camera rule admits (normal . (-optical axis) >=
``visibleCorrelation``). Nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.scenes import Camera, Scene
from benchmark.scenes.curved_facade import rotation_to_quaternion

RADIUS = 1.0            # the object's mean radius
BUMP = 0.12             # relative height of its bumps
ELEVATION = (10.0, 80.0)
FILL = 2.0 / 3.0        # share of the frame height the object spans
MARCH = 96              # bracketing steps along a ray
BISECT = 48             # bisection steps after the bracket
MARGIN = 20             # pixels a seed's measurement keeps from the edge
                        # (at a height of 480; in proportion otherwise)
EDGE = 3                # pixels the object keeps from the edge: K1's margins
GOLDEN = math.pi * (3.0 - math.sqrt(5.0))


def bumps(d):
    """The object's relative bumps at unit directions d [..., 3] (torch or
    numpy), in [-1, 1]."""
    lib = torch if torch.is_tensor(d) else np
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return 0.5 * (lib.sin(2.3 * x + 0.7) * lib.cos(1.9 * y)
                  + lib.sin(1.7 * z + 2.1 * x) * lib.cos(1.3 * y - 0.4))


def radius_at(d):
    return RADIUS * (1.0 + BUMP * bumps(d))


R_MAX = RADIUS * (1.0 + BUMP)


def lookat(center: np.ndarray) -> np.ndarray:
    """World-to-camera rotation of a camera at ``center`` looking at the
    origin, +z forward, image y down, world z up."""
    f = -center / np.linalg.norm(center)
    x = np.cross(f, np.array([0.0, 0.0, 1.0]))
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(f, x), f], axis=0)


def camera_centers(C: int, distance: float) -> np.ndarray:
    """C positions on a Fibonacci lattice of the hemisphere (equal area),
    elevations between ELEVATION degrees, at ``distance``."""
    s0, s1 = (math.sin(math.radians(e)) for e in ELEVATION)
    k = np.arange(C)
    sz = s0 + (s1 - s0) * (k + 0.5) / C
    cz = np.sqrt(1.0 - sz * sz)
    az = k * GOLDEN
    return distance * np.stack([cz * np.cos(az), cz * np.sin(az), sz], -1)


class StarObject:
    """The object's analytic surface: ``cast`` (nearest hit of rays) and
    ``distance`` (radial residual), in float64 on the CPU."""

    def cast(self, o, dirs):
        """Nearest hit of rays ``o + t dirs``; returns (t [N], kind [N]:
        0 hit, 1 miss with t = inf)."""
        o = np.array(np.broadcast_to(np.asarray(o, float), np.shape(dirs)))
        t, hit = cast(torch.as_tensor(o), torch.as_tensor(np.array(
            dirs, dtype=float)))
        t = t.numpy()
        return np.where(hit.numpy(), t, np.inf), (~hit.numpy()).astype(
            np.int32)

    def distance(self, X) -> np.ndarray:
        """|X| - r(X / |X|): the radial residual (the bumps are gentle, so
        it is the distance to first order)."""
        X = np.atleast_2d(np.asarray(X, float))
        n = np.linalg.norm(X, axis=-1)
        return np.abs(n - radius_at(X / np.maximum(n, 1e-12)[:, None]))


def inside(p):
    """|p| - r(p / |p|): negative inside the object."""
    n = torch.linalg.norm(p, dim=-1)
    return n - radius_at(p / n.clamp_min(1e-12)[..., None])


def cast(o: torch.Tensor, dirs: torch.Tensor):
    """First crossing of rays o + t dirs [..., 3] (float64, one device)
    with the surface: (t, hit). Bracketed by MARCH steps between the
    bounding sphere's entry and exit, then bisected."""
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    b = (o * dirs).sum(-1)
    c = (o * o).sum(-1) - R_MAX * R_MAX
    disc = b * b - c
    meets = disc > 0
    sq = torch.sqrt(disc.clamp_min(0.0))
    t0, t1 = -b - sq, -b + sq
    step = (t1 - t0) / MARCH
    lo = t0.clone()
    hi = torch.full_like(t0, math.nan)
    found = torch.zeros_like(meets)
    for k in range(1, MARCH + 1):
        t = t0 + k * step
        now = ~found & (inside(o + t[..., None] * dirs) <= 0)
        hi = torch.where(now, t, hi)
        found |= now
        lo = torch.where(found, lo, t)
    hit = meets & found
    lo = torch.where(hit, lo, 0.0)
    hi = torch.where(hit, hi, 0.0)
    for _ in range(BISECT):
        mid = 0.5 * (lo + hi)
        out = inside(o + mid[..., None] * dirs) > 0
        lo = torch.where(out, mid, lo)
        hi = torch.where(out, hi, mid)
    return 0.5 * (lo + hi), hit


def normal_at(p: torch.Tensor) -> torch.Tensor:
    """Outward unit normals of surface points p [N, 3] (central
    differences of ``inside``)."""
    eps = 1e-6
    g = torch.stack([inside(p + eps * e) - inside(p - eps * e)
                     for e in torch.eye(3, dtype=p.dtype, device=p.device)],
                    -1)
    return g / torch.linalg.norm(g, dim=-1, keepdim=True)


def texture(d, grids):
    """Three-octave value noise over unit directions d [..., 3], range
    ~[40, 220]."""
    total = torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)
    amp = 1.0
    for grid in grids:
        n = grid.shape[0]
        g = ((d + 1.1) / 2.2).clamp(0, 1) * (n - 1)
        i0 = torch.floor(g).long().clamp(0, n - 2)
        f = g - i0
        acc = torch.zeros_like(total)
        for dx in (0, 1):
            wx = f[..., 0] if dx else 1 - f[..., 0]
            for dy in (0, 1):
                wy = f[..., 1] if dy else 1 - f[..., 1]
                for dz in (0, 1):
                    wz = f[..., 2] if dz else 1 - f[..., 2]
                    acc += wx * wy * wz * grid[i0[..., 0] + dx,
                                               i0[..., 1] + dy,
                                               i0[..., 2] + dz]
        total += amp * acc
        amp *= 0.5
    return 130.0 + 90.0 * total / 1.75


def rim_blur(val: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """The silhouette's edge blurred by one pixel, as a lens blurs it: a
    background pixel beside the object ([n, 1, H, W]) takes half the mean
    of its object neighbours (3x3), at least 1; the object's pixels keep
    their texture, at least 1; the rest stays 0."""
    k = torch.ones((1, 1, 3, 3), dtype=val.dtype, device=val.device)
    conv = lambda x: torch.nn.functional.conv2d(x, k, padding=1)
    n = conv(hit.to(val.dtype))
    edge = torch.where(n > 0, 0.5 * conv(val) / n.clamp(min=1), 0.0)
    return torch.where(hit, val.clamp(min=1), torch.where(
        n > 0, edge.clamp(min=1), 0.0))


def render(cfg: dict, seed: int, device=None) -> Scene:
    W, H = int(cfg["width"]), int(cfg["height"])
    C, num_seeds = int(cfg["cameras"]), int(cfg["seeds"])
    f = float(cfg["focal"])
    cone = float(cfg["config_txt"].get("visibleCorrelation", 0.7))
    dev = torch.device(device or "cpu")
    f64 = torch.float64
    gen = torch.Generator(dev).manual_seed(int(cfg["scene_seed"]))
    grids = [torch.rand((n,) * 3, generator=gen, dtype=f64, device=dev)
             * 2 - 1 for n in (17, 33, 65)]
    # the bounding sphere spans FILL of the frame height
    half = math.atan(FILL * H / 2.0 / f)
    distance = R_MAX / math.sin(half)
    centers = camera_centers(C, distance)
    Rs = [lookat(c) for c in centers]
    pp = np.array([W >> 1, H >> 1], dtype=np.float64)

    # the object whole inside every frame (EDGE pixels in): the runtime
    # filter drops any patch whose centre leaves one frame
    sph = torch.rand((20000, 3), generator=gen, dtype=f64, device=dev) * 2 - 1
    sph = sph / torch.linalg.norm(sph, dim=-1, keepdim=True)
    shell = (sph * radius_at(sph)[:, None]).cpu().numpy()
    for c, R in zip(centers, Rs):
        xc = (shell - c) @ R.T
        u = f * xc[:, 0] / xc[:, 2] + pp[0]
        v = f * xc[:, 1] / xc[:, 2] + pp[1]
        assert (u.min() >= EDGE and u.max() < W - EDGE
                and v.min() >= EDGE and v.max() < H - EDGE), \
            "the object leaves a frame"

    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    d_cam = torch.stack([(xs - pp[0]) / f, (ys - pp[1]) / f,
                         torch.ones_like(xs)], -1).reshape(-1, 3)
    images, cams = [], []
    per = 16                                  # cameras cast at once
    for s in range(0, C, per):
        Rt = torch.as_tensor(np.stack(Rs[s:s + per]), dtype=f64, device=dev)
        ct = torch.as_tensor(centers[s:s + per], dtype=f64, device=dev)
        dirs = torch.einsum("pk,nkj->npj", d_cam, Rt)        # R^T d
        o = ct[:, None, :].expand_as(dirs)
        t, hit = cast(o, dirs)
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        p = o + t[..., None] * dirs
        d = p / torch.linalg.norm(p, dim=-1, keepdim=True)
        val = torch.where(hit, texture(d, grids), 0.0).reshape(-1, 1, H, W)
        img = torch.round(rim_blur(val, hit.reshape(-1, 1, H, W))).clamp(
            0, 255).to(torch.uint8)[:, 0]
        for k in range(img.shape[0]):
            images.append(img[k, ..., None].expand(H, W, 3).cpu().numpy()
                          .copy())
        del dirs, o, t, hit, p, d, img
    for i, (c, R) in enumerate(zip(centers, Rs)):
        cams.append(Camera(name=f"temple{i:03d}.png", focal=f,
                           quaternion=rotation_to_quaternion(R), center=c,
                           radial=0.0, width=W, height=H))
    del d_cam, xs, ys, grids

    # seed points on the surface above the lowest cameras' horizon
    u = torch.rand((num_seeds, 2), generator=gen, dtype=f64, device=dev)
    z = -0.2 + 1.2 * u[:, 0]
    az = 2 * math.pi * u[:, 1]
    rz = torch.sqrt((1 - z * z).clamp_min(0))
    d = torch.stack([rz * torch.cos(az), rz * torch.sin(az), z], -1)
    pts = d * radius_at(d)[:, None]
    nrm = normal_at(pts)
    ct = torch.as_tensor(centers, dtype=f64, device=dev)
    Rt = torch.as_tensor(np.stack(Rs), dtype=f64, device=dev)
    ray = pts[:, None, :] - ct[None]                         # [M, C, 3]
    dist = torch.linalg.norm(ray, dim=-1)
    t, hit = cast(ct[None].expand_as(ray), ray)
    seen = hit & (torch.abs(t - dist) < 1e-6 * dist)
    xc = torch.einsum("mcj,ckj->mck", ray, Rt)
    uu = f * xc[..., 0] / xc[..., 2] + pp[0]
    vv = f * xc[..., 1] / xc[..., 2] + pp[1]
    facing = -(nrm[:, None, :] * Rt[None, :, 2, :]).sum(-1)
    m = max(round(MARGIN * H / 480), 1)
    masks = (seen & (uu >= m) & (uu < W - m) & (vv >= m) & (vv < H - m)
             & (facing >= cone))
    min_cams = int(cfg["config_txt"].get("minCamNum", 3))
    keep = (masks.sum(1) >= min_cams).cpu().numpy()
    masks = masks.cpu().numpy()
    ipts = torch.stack([uu, vv], -1).cpu().numpy()
    pts = pts.cpu().numpy()
    return Scene(cameras=cams, images=images, seed_points=pts[keep],
                 seed_masks=masks[keep], seed_pixels=ipts[keep],
                 surface=StarObject())
