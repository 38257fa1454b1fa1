"""A textured object standing on a table, seen from a cap of positions
above it: the shape of the DTU multi-view stereo set (Aanaes, Jensen,
Vogiatzis, Tola and Dahl, IJCV 2016), whose 49 camera positions of a robot
arm look down at a table-top object, 1600x1200 pixels each, calibrated,
with no SfM points.

The object is ``hemisphere_object``'s closed star-shaped value-noise solid
(its shape, texture and ray cast imported). It stands on a flat table: the
plane z = TABLE_Z, a square of half-side TABLE_HALF, which cuts off the
object's lower part, textured with the same three-octave value noise over
its own lattice (grey 40-220, never 0). Rays that meet neither read the
constant backdrop grey BACKDROP, so no pixel is 0 and the program's runtime
filter (a patch whose centre falls on a 0 pixel of a view is dropped) never
fires on the images' content. The analytic surface is the union of the
object above the table and the table: ``cast`` takes the nearer hit,
``distance`` the nearer of the object's radial residual and the height
above the table (within its square).

The rig: ``rows`` rows of cameras between ELEVATION degrees, each row of
``cameras / rows`` azimuths spread evenly within +-AZIMUTH degrees (a
configuration may name others: ``elevation``, ``azimuth``), all
looking at the origin from the distance where the object's bounding sphere
spans FILL of the frame height; the focal length is the configuration's,
the principal point the image centre (as NVM_V3 gives it to the program).
``render`` asserts that the object lies whole inside every frame. The
scene has no seed points: the NVM holds the cameras alone, so the program
seeds from its own features. The configuration's ``scene_seed`` draws the
noise lattices; every run renders the same scene. Nothing of the program is
imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.scenes import Camera, Scene
from benchmark.scenes import hemisphere_object as HO
from benchmark.scenes.curved_facade import rotation_to_quaternion

TABLE_Z = -0.6          # the table's height (the object's mean radius 1)
TABLE_HALF = 3.0        # half the side of the table's square
BACKDROP = 36.0         # the grey of rays that miss object and table
ELEVATION = (15.0, 55.0)
AZIMUTH = 45.0
FILL = 2.0 / 3.0        # share of the frame height the object spans
EDGE = 3                # pixels the object keeps from the edge: K1's margins
# the table's noise lattices: the finest cell some 18 pixels at the rig's
# distance, as fine as the object's
TABLE_GRIDS = (33, 65, 129)


def camera_centers(cfg: dict, distance: float) -> np.ndarray:
    """The rig's positions [C, 3]: ``rows`` rows of elevations within
    ``elevation`` (ELEVATION), ``cameras / rows`` azimuths within
    +-``azimuth`` (AZIMUTH) degrees each, row by row from the lowest, at
    ``distance`` from the origin."""
    C, rows = int(cfg["cameras"]), int(cfg["rows"])
    per = C // rows
    assert per * rows == C, "the rows must share the cameras evenly"
    el = np.radians(np.linspace(*cfg.get("elevation", ELEVATION), rows))
    span = float(cfg.get("azimuth", AZIMUTH))
    az = np.radians(np.linspace(-span, span, per)) - math.pi / 2
    e, a = np.meshgrid(el, az, indexing="ij")
    e, a = e.reshape(-1), a.reshape(-1)
    return distance * np.stack([np.cos(e) * np.cos(a),
                                np.cos(e) * np.sin(a), np.sin(e)], -1)


def table_hit(o, dirs):
    """Distance along unit rays ``o + t dirs`` [..., 3] (float64, torch)
    to the table's square, and whether they meet it there."""
    dz = dirs[..., 2]
    dz = torch.where(dz == 0, torch.full_like(dz, -1e-300), dz)
    t = (TABLE_Z - o[..., 2]) / dz
    p = o + t[..., None] * dirs
    hit = ((t > 0) & (p[..., 0].abs() <= TABLE_HALF)
           & (p[..., 1].abs() <= TABLE_HALF))
    return t, hit


def union_cast(o, dirs):
    """Nearest hit of rays ``o + t dirs`` [..., 3] (float64 torch, one
    device) with the object above the table or the table: (t along the
    unit rays, what was hit: 0 the object, 1 the table, 2 nothing)."""
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    t_obj, h_obj = HO.cast(o, dirs)
    # the object's part below the table is hidden by it: a ray from above
    # meets the table first there
    h_obj &= (o + t_obj[..., None] * dirs)[..., 2] >= TABLE_Z
    t_tab, h_tab = table_hit(o, dirs)
    inf = torch.full_like(t_obj, math.inf)
    t_obj = torch.where(h_obj, t_obj, inf)
    t_tab = torch.where(h_tab, t_tab, inf)
    kind = torch.where(t_obj <= t_tab, 0, 1)
    t = torch.minimum(t_obj, t_tab)
    kind = torch.where(torch.isinf(t), 2, kind)
    return t, kind


class TableObject:
    """The analytic surface: ``cast`` (nearest hit of rays) and
    ``distance``, in float64 on the CPU."""

    def cast(self, o, dirs):
        """Nearest hit of rays ``o + t dirs``; returns (t [N], kind [N]:
        0 hit, 1 miss with t = inf)."""
        o = np.array(np.broadcast_to(np.asarray(o, float), np.shape(dirs)))
        t, kind = union_cast(torch.as_tensor(o), torch.as_tensor(
            np.array(dirs, dtype=float)))
        return t.numpy(), (kind.numpy() == 2).astype(np.int32)

    def distance(self, X) -> np.ndarray:
        """The nearer of the object's radial residual (points above the
        table) and the height above the table (points over its square)."""
        X = np.atleast_2d(np.asarray(X, float))
        obj = np.where(X[:, 2] >= TABLE_Z, HO.StarObject().distance(X),
                       np.inf)
        over = (np.abs(X[:, 0]) <= TABLE_HALF) & (np.abs(X[:, 1])
                                                  <= TABLE_HALF)
        tab = np.where(over, np.abs(X[:, 2] - TABLE_Z), np.inf)
        return np.minimum(obj, tab)


def render(cfg: dict, seed: int, device=None) -> Scene:
    W, H = int(cfg["width"]), int(cfg["height"])
    C = int(cfg["cameras"])
    f = float(cfg["focal"])
    dev = torch.device(device or "cpu")
    f64 = torch.float64
    gen = torch.Generator(dev).manual_seed(int(cfg["scene_seed"]))
    grids = [torch.rand((n,) * 3, generator=gen, dtype=f64, device=dev)
             * 2 - 1 for n in (17, 33, 65)]
    table_grids = [torch.rand((n,) * 3, generator=gen, dtype=f64,
                              device=dev) * 2 - 1 for n in TABLE_GRIDS]
    # the bounding sphere spans FILL of the frame height
    half = math.atan(FILL * H / 2.0 / f)
    distance = HO.R_MAX / math.sin(half)
    centers = camera_centers(cfg, distance)
    Rs = [HO.lookat(c) for c in centers]
    pp = np.array([W >> 1, H >> 1], dtype=np.float64)

    # the object whole inside every frame (EDGE pixels in)
    sph = torch.rand((20000, 3), generator=gen, dtype=f64, device=dev) * 2 - 1
    sph = sph / torch.linalg.norm(sph, dim=-1, keepdim=True)
    shell = (sph * HO.radius_at(sph)[:, None]).cpu().numpy()
    shell = shell[shell[:, 2] >= TABLE_Z]
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
    per = max(1, (16 * 640 * 480) // (W * H))   # cameras cast at once
    for s in range(0, C, per):
        Rt = torch.as_tensor(np.stack(Rs[s:s + per]), dtype=f64, device=dev)
        ct = torch.as_tensor(centers[s:s + per], dtype=f64, device=dev)
        dirs = torch.einsum("pk,nkj->npj", d_cam, Rt)        # R^T d
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        o = ct[:, None, :].expand_as(dirs)
        t, kind = union_cast(o, dirs)
        p = o + torch.where(kind < 2, t, 0.0)[..., None] * dirs
        d = p / torch.linalg.norm(p, dim=-1, keepdim=True).clamp_min(1e-12)
        val = torch.full_like(t, BACKDROP)
        val = torch.where(kind == 0, HO.texture(d, grids), val)
        val = torch.where(kind == 1, HO.texture(p / TABLE_HALF,
                                                table_grids), val)
        img = torch.round(val).clamp(1, 255).to(torch.uint8).reshape(
            -1, H, W)
        for k in range(img.shape[0]):
            images.append(img[k, ..., None].expand(H, W, 3).cpu().numpy()
                          .copy())
        del dirs, o, t, kind, p, d, val, img
    for i, (c, R) in enumerate(zip(centers, Rs)):
        cams.append(Camera(name=f"dtu{i:03d}.png", focal=f,
                           quaternion=rotation_to_quaternion(R), center=c,
                           radial=0.0, width=W, height=H))
    del d_cam, xs, ys, grids, table_grids
    return Scene(cameras=cams, images=images,
                 seed_points=np.zeros((0, 3)),
                 seed_masks=np.zeros((0, C), dtype=bool),
                 seed_pixels=np.zeros((0, C, 2)), surface=TableObject())
