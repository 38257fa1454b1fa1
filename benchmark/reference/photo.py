"""The plain reference of a patch's photoconsistency, its visible cameras
and its depth, worked out from the input PNG files.

Plain PyTorch in float64 on the given device (the CPU in tests). It
imports nothing of the program and takes nothing the program made: the
pyramid is built again from the PNGs (grey by BT.601, area resampling by
lodRatio**l, levels rounded to 8-bit integers, window-variance maps), and
a patch's windows are warped by intersecting each reference pixel's ray
with the patch plane rather than by the program's homographies.

The scoring follows the upstream definition (PAIS::getFitness,
TMVS/mvs/patch.cpp:914-1047, as frozen in ``pais_mvs_tpu_torch/ops/
fitness.py`` at commit 04b33df): per window pixel the mean over the
visible cameras and their mean absolute deviation (SAD), weighted by a
normalised Gaussian of the distance to the window centre and by
exp(-SAD^2 / diffWeighting); intensity-0 reference pixels are background;
a warp outside [2, dim-3) in a visible camera on a foreground pixel
rejects the candidate (BIG). The correlation is the mean off-diagonal
normalised cross-correlation of the raw windows (patch.cpp:249-266,
bounds [0, dim-1)); the level of detail climbs the pyramid until the
window variance reaches textureVariation (patch.cpp:511-610); the
visible-camera rule is Patch::removeInvisibleCamera (patch.cpp:655-721).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np
import torch

F64 = torch.float64
BIG = 1e30

# MvsConfig defaults (TMVS/TMVS.cpp:26-52) and their config.txt keys
DEFAULTS = {"patchRadius": 15, "distWeighting": 5.0,
            "diffWeighting": 128.0 * 128.0, "textureVariation": 36.0,
            "minLOD": 0, "maxLOD": 15, "lodRatio": 0.8,
            "minCorrelation": 0.7, "minRegionRatio": 0.55}


def engine_params(config_txt: dict) -> dict:
    return {**DEFAULTS, **{k: v for k, v in config_txt.items()
                          if k in DEFAULTS}}


def quat_to_R(q) -> np.ndarray:
    """Rotation of a quaternion (w, x, y, z), normalised first."""
    w, x, y, z = np.asarray(q, float) / np.linalg.norm(q)
    return np.array([
        [w * w + x * x - y * y - z * z, 2 * (x * y - z * w),
         2 * (y * w + z * x)],
        [2 * (x * y + w * z), y * y + w * w - z * z - x * x,
         2 * (z * y - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + w * x),
         z * z + w * w - y * y - x * x]])


def area_resample(f: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """Exact area (box-overlap) resampling of f along ``axis`` to n_out
    samples: each output is the mean of the piecewise-constant input over
    its interval (OpenCV INTER_AREA at any scale)."""
    f = f.movedim(axis, 0)
    n_in = f.shape[0]
    F = torch.cat([f.new_zeros((1,) + f.shape[1:]), torch.cumsum(f, 0)])
    edges = torch.arange(n_out + 1, dtype=F64, device=f.device) * (
        n_in / n_out)
    e0 = torch.floor(edges).long().clamp(0, n_in)
    frac = (edges - e0).reshape((-1,) + (1,) * (f.dim() - 1))
    tail = f[e0.clamp(max=n_in - 1)] * (e0 < n_in).reshape(frac.shape)
    Fe = F[e0] + frac * tail
    out = (Fe[1:] - Fe[:-1]) / (edges[1:] - edges[:-1]).reshape(
        (-1,) + (1,) * (f.dim() - 1))
    return out.movedim(0, axis)


def window_variance(g: torch.Tensor, r: int) -> torch.Tensor:
    """Population variance of the (2r+1)^2 window at every pixel, -1 where
    the window leaves the image."""
    h, w = g.shape
    k = 2 * r + 1
    out = torch.full((h, w), -1.0, dtype=F64, device=g.device)
    if h < k or w < k:
        return out

    def integral(a):
        s = torch.zeros((h + 1, w + 1), dtype=F64, device=g.device)
        s[1:, 1:] = a.cumsum(0).cumsum(1)
        return s[k:, k:] - s[:-k, k:] - s[k:, :-k] + s[:-k, :-k]

    m = integral(g) / (k * k)
    var = integral(g * g) / (k * k) - m * m
    out[r:h - r, r:w - r] = var.clamp_min(0.0)
    return out


def level_size(h0: int, w0: int, s: float):
    return max(int(round(h0 * s)), 1), max(int(round(w0 * s)), 1)


class RefScene:
    """The rig and the pyramids of the input PNGs.

    The reference keeps ``dtype`` float64. The control is the same code
    one step below each precision the configuration states: ``dtype``
    bfloat16 for the float32 arithmetic, ``quantize="fp8"`` (float8 e4m3)
    for the bfloat16 atlas."""

    def __init__(self, scene_dir: str, cameras: List, params: dict,
                 device="cpu", dtype=F64, quantize: Optional[str] = None):
        from PIL import Image
        self.p = params
        self.dev = torch.device(device)
        self.dt = dtype
        r = int(params["patchRadius"])
        ratio = float(params["lodRatio"])
        R, C, f, pp = [], [], [], []
        self.levels, self.var, self.dims, self.max_lod = [], [], [], []
        for cam in cameras:
            img = np.array(Image.open(os.path.join(scene_dir, cam.name))
                           .convert("RGB"))
            h0, w0 = img.shape[:2]
            t = torch.as_tensor(img, device=self.dev).to(F64)
            grey = torch.round(0.299 * t[..., 0] + 0.587 * t[..., 1]
                               + 0.114 * t[..., 2]).clamp(0, 255)
            L = min(int(math.log(max(w0, h0)) / math.log(1.0 / ratio)),
                    int(params["maxLOD"]))
            levels, var, dims = [], [], []
            for l in range(L + 1):
                h, w = level_size(h0, w0, ratio ** l)
                g = grey if l == 0 else torch.round(area_resample(
                    area_resample(grey, h, 0), w, 1)).clamp(0, 255)
                var.append(window_variance(g, r))
                if quantize == "fp8":
                    g = g.to(torch.float8_e4m3fn)
                levels.append(g.to(dtype))
                dims.append((h, w))
            self.levels.append(levels)
            self.var.append(var)
            self.dims.append(dims)
            self.max_lod.append(L)
            R.append(quat_to_R(cam.quaternion))
            C.append(np.asarray(cam.center, float))
            f.append(float(cam.focal))
            pp.append((float(w0 >> 1), float(h0 >> 1)))
        tt = lambda a: torch.as_tensor(np.asarray(a, float), dtype=F64,
                                       device=self.dev).to(dtype)
        self.Rt, self.Ct, self.ft, self.ppt = tt(R), tt(C), tt(f), tt(pp)
        self.optical = self.Rt[:, 2, :]          # R^T (0, 0, 1)
        self.num_cameras = len(cameras)

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a, float), dtype=F64,
                               device=self.dev).to(self.dt)

    # -- geometry ----------------------------------------------------------
    def project(self, X, cam, s=1.0):
        """Pixels of world points X [..., 3] in camera(s) ``cam`` (an int
        or a long tensor broadcast against X[..., 0]) at LOD scale s;
        returns (xy [..., 2], z [...])."""
        xc = ((X - self.Ct[cam])[..., None, :] * self.Rt[cam]).sum(-1)
        z = xc[..., 2]
        sz = torch.where(z == 0, 1.0, z)
        u = self.ft[cam] * xc[..., 0] / sz + self.ppt[cam][..., 0]
        v = self.ft[cam] * xc[..., 1] / sz + self.ppt[cam][..., 1]
        return torch.stack([u, v], -1) * (s[..., None] if torch.is_tensor(s)
                                          else s), z

    def ref_camera(self, normal, mask):
        """argmax over the visible cameras of normal . (-optical axis)."""
        score = -(normal[:, None, :] * self.optical).sum(-1)
        return torch.argmax(torch.where(mask, score, -torch.inf), -1)

    def lod(self, center, ref):
        """Level of detail of every row (patch.cpp:511-610): the first
        level from minLOD that is the camera's last (take it), whose
        window leaves the frame or whose projection does (take the one
        before), or whose window variance reaches textureVariation (take
        it). center [N, 3], ref [N] -> [N] long."""
        ratio = float(self.p["lodRatio"])
        thr = float(self.p["textureVariation"])
        N = len(ref)
        lmax = torch.as_tensor(self.max_lod, device=self.dev)[ref]
        out = lmax.clone()
        done = torch.zeros(N, dtype=torch.bool, device=self.dev)
        for l in range(int(self.p["minLOD"]), int(lmax.max()) + 1):
            cap = ~done & (l >= lmax)
            out[cap] = lmax[cap]
            done |= cap
            pt, z = self.project(center, ref, ratio ** l)
            var = torch.full((N,), -1.0, dtype=F64, device=self.dev)
            inside = torch.zeros(N, dtype=torch.bool, device=self.dev)
            for c in torch.unique(ref[~done]).tolist():
                rows = (ref == c) & ~done
                h, w = self.dims[c][l]
                x, y = pt[rows, 0], pt[rows, 1]
                ins = ((x >= 0) & (x < w) & (y >= 0) & (y < h) & (z[rows] > 0)
                       & torch.isfinite(x) & torch.isfinite(y))
                xi = torch.round(torch.where(ins, x, 0.0)).long().clamp(
                    0, w - 1)
                yi = torch.round(torch.where(ins, y, 0.0)).long().clamp(
                    0, h - 1)
                var[rows] = torch.where(ins, self.var[c][l][yi, xi], -1.0)
                inside[rows] = ins
            oob = ~done & (~inside | (var < 0))
            out[oob] = max(l - 1, 0)
            done |= oob
            tex = ~done & (var >= thr)
            out[tex] = l
            done |= tex
        return out

    def offsets(self):
        r = int(self.p["patchRadius"])
        ax = torch.arange(-r, r + 1, dtype=F64, device=self.dev)
        dx, dy = torch.meshgrid(ax, ax, indexing="ij")
        return torch.stack([dx.reshape(-1), dy.reshape(-1)], -1).to(self.dt)

    def dist_weights(self):
        sig = float(self.p["distWeighting"])
        r = int(self.p["patchRadius"])
        ax = torch.arange(-r, r + 1, dtype=F64, device=self.dev)
        dx, dy = torch.meshgrid(ax, ax, indexing="ij")
        g = torch.exp(-(dx * dx + dy * dy).reshape(-1) / (2.0 * sig * sig))
        return (g / g.sum()).to(self.dt)

    def warp(self, win, center, normal, ref, cam, s):
        """Pixels in camera ``cam`` at LOD scale s of reference-window
        pixels ``win`` [N, ..., 2] (reference camera ``ref`` [N], same
        scale) on the plane through ``center`` [N, ..., 3] with
        ``normal`` [N, 3]; returns (uv, ok)."""
        extra = (None,) * (win.dim() - 2)
        sel = lambda a: a[ref][(slice(None),) + extra]
        s_b = s[(slice(None),) + extra]
        xn = (win[..., 0] / s_b - sel(self.ppt)[..., 0]) / sel(self.ft)
        yn = (win[..., 1] / s_b - sel(self.ppt)[..., 1]) / sel(self.ft)
        dcam = torch.stack([xn, yn, torch.ones_like(xn)], -1)
        d = (dcam[..., :, None] * sel(self.Rt)).sum(-2)      # R^T dcam
        nb = normal[(slice(None),) + extra]
        denom = (nb * d).sum(-1)
        num = (nb * (center[..., None, :] - sel(self.Ct))).sum(-1)
        t = num / torch.where(denom == 0, 1.0, denom)
        X = sel(self.Ct) + t[..., None] * d
        uv, z = self.project(X, cam, s_b)
        return uv, (denom != 0) & (z != 0)

    def sample(self, cam, lod, uv, lo, hi):
        """Bilinear samples of camera ``cam``'s level ``lod[n]`` at uv
        [N, ..., 2]; valid iff lo <= p < dim - hi."""
        vals = torch.zeros(uv.shape[:-1], dtype=self.dt, device=self.dev)
        ok = torch.zeros(uv.shape[:-1], dtype=torch.bool, device=self.dev)
        for l in torch.unique(lod).tolist():
            rows = lod == l
            img = self.levels[cam][min(l, self.max_lod[cam])]
            h, w = img.shape
            u, v = uv[rows][..., 0], uv[rows][..., 1]
            good = ((u >= lo) & (u < w - hi) & (v >= lo) & (v < h - hi)
                    & torch.isfinite(u) & torch.isfinite(v))
            u, v = torch.where(good, u, 0.0), torch.where(good, v, 0.0)
            x0, y0 = torch.floor(u), torch.floor(v)
            fx, fy = u - x0, v - y0
            xi = x0.long().clamp(0, w - 2)
            yi = y0.long().clamp(0, h - 2)
            vals[rows] = (img[yi, xi] * (1 - fx) * (1 - fy)
                          + img[yi, xi + 1] * fx * (1 - fy)
                          + img[yi + 1, xi] * (1 - fx) * fy
                          + img[yi + 1, xi + 1] * fx * fy)
            ok[rows] = good
        return vals, ok

    def nearest(self, cam, lod, xy):
        """Round-to-nearest samples of camera ``cam[n]``'s level
        ``lod[n]`` at xy [N, ..., 2]."""
        out = torch.zeros(xy.shape[:-1], dtype=self.dt, device=self.dev)
        for c in torch.unique(cam).tolist():
            for l in torch.unique(lod[cam == c]).tolist():
                rows = (cam == c) & (lod == l)
                img = self.levels[c][l]
                h, w = img.shape
                xi = torch.round(xy[rows][..., 0]).long().clamp(0, w - 1)
                yi = torch.round(xy[rows][..., 1]).long().clamp(0, h - 1)
                out[rows] = img[yi, xi]
        return out

    # -- the scores -------------------------------------------------------
    def windows(self, center, ref, lod):
        """Reference-window pixels [N, P, W2, 2] around the projections
        of ``center`` [N, P, 3], their centres [N, P, 2] and each row's
        LOD scale [N]."""
        s = torch.pow(torch.full(lod.shape, float(self.p["lodRatio"]),
                                 dtype=F64, device=self.dev),
                      lod.to(F64)).to(self.dt)
        pt, _ = self.project(center, ref[:, None], s[:, None])
        return pt[..., None, :] + self.offsets(), pt, s

    def fitness(self, center, normal, ref, mask, lod):
        """Photoconsistency of the plane hypotheses ``center`` [N, P, 3]
        with ``normal`` [N, 3], reference camera ``ref`` [N], visible
        cameras ``mask`` [N, C] and level ``lod`` [N]; BIG where rejected.
        -> [N, P] float64."""
        r = int(self.p["patchRadius"])
        win, pt, s = self.windows(center, ref, lod)
        N, P = center.shape[:2]
        dims = self.tensor([self.dims[c][l] for c, l in
                            zip(ref.tolist(), lod.tolist())]).reshape(N, 2)
        h, w = dims[:, None, 0], dims[:, None, 1]
        # the window inside the reference frame, the normal facing it
        pvalid = ((pt[..., 0] - r >= 2) & (pt[..., 0] + r < w - 3)
                  & (pt[..., 1] - r >= 2) & (pt[..., 1] + r < h - 3))
        pvalid &= ((normal * self.optical[ref]).sum(-1) <= 0)[:, None]
        W2 = win.shape[2]
        fg = self.nearest(ref[:, None, None].expand(N, P, W2),
                          lod[:, None, None].expand(N, P, W2), win) != 0
        vals = []
        killed = torch.zeros(N, P, dtype=torch.bool, device=self.dev)
        for c in range(self.num_cameras):
            uv, hok = self.warp(win, center, normal, ref, c, s)
            v, ok = self.sample(c, lod, uv, 2.0, 3.0)
            m = mask[:, c][:, None, None]
            killed |= (m & ~(ok & hok) & fg).any(-1)
            vals.append(torch.where(m, v, 0.0))
        n = mask.sum(-1).to(self.dt)[:, None, None]
        mean = sum(vals) / n
        sad = sum(torch.where(mask[:, c][:, None, None],
                              (vals[c] - mean).abs(), 0.0)
                  for c in range(self.num_cameras)) / n
        weight = self.dist_weights() * torch.exp(
            -sad * sad / float(self.p["diffWeighting"]))
        wfg = weight * fg
        sw = wfg.sum(-1)
        fit = (wfg * sad).sum(-1) / torch.where(sw > 0, sw, 1.0)
        return torch.where(pvalid & ~killed & (sw > 0), fit.to(F64), BIG)

    def correlation(self, center, normal, ref, mask, lod):
        """(mean off-diagonal NCC [N] float64, table [N, C, C], ok [N]) of
        the windows of patches ``center`` [N, 3]."""
        win, pt, s = self.windows(center[:, None], ref, lod)
        win = win[:, 0]
        C = self.num_cameras
        vecs, ok = [], mask.new_ones(len(ref))
        for c in range(C):
            uv, hok = self.warp(win, center, normal, ref, c, s)
            v, vok = self.sample(c, lod, uv, 0.0, 1.0)
            vok &= hok
            m = mask[:, c]
            ok &= vok.all(-1) | ~m
            v = torch.where(vok & m[:, None], v, 0.0)
            nrm = torch.sqrt((v * v).sum(-1, keepdim=True))
            vecs.append(v / torch.where(nrm > 0, nrm, 1.0))
        V = torch.stack(vecs, 1)                            # [N, C, W2]
        table = (V[:, :, None, :] * V[:, None, :, :]).sum(-1)
        eye = torch.eye(C, dtype=torch.bool, device=self.dev)
        pair = mask[:, :, None] & mask[:, None, :] & ~eye
        table = table * pair
        n = mask.sum(-1).to(self.dt)
        den = n * n - n
        corr = table.sum((1, 2)) / torch.where(den > 0, den, 1.0)
        return torch.where(ok, corr, 0.0).to(F64), table, ok

    def region_ratio(self, center, normal, ref, lod):
        """min/max singular value of each camera's warp Jacobian at the
        window centre (central differences of half a pixel) -> [N, C]."""
        _, pt, s = self.windows(center[:, None], ref, lod)
        pt = pt[:, 0]
        e = 0.5
        offs = self.tensor([[e, 0], [-e, 0], [0, e], [0, -e]])
        pts = pt[:, None, :] + offs                         # [N, 4, 2]
        out = []
        for c in range(self.num_cameras):
            uv, _ = self.warp(pts, center, normal, ref, c, s)
            jx = (uv[:, 0] - uv[:, 1]) / (2 * e)
            jy = (uv[:, 2] - uv[:, 3]) / (2 * e)
            sv = torch.linalg.svdvals(torch.stack([jx, jy], -1).to(F64))
            out.append(torch.where(sv[:, 0] > 0, sv[:, 1] / sv[:, 0], 0.0))
        return torch.stack(out, -1)

    def removed_cameras(self, center, normal, ref, mask, lod):
        """The visible cameras that Patch::removeInvisibleCamera would drop
        from ``mask`` [N, C] -> [N, C] bool."""
        _, table, _ = self.correlation(center, normal, ref, mask, lod)
        C = self.num_cameras
        table = table.to(F64)
        rows = torch.where(mask, table.sum(-1), -torch.inf)
        best = C - 1 - torch.argmax(torch.flip(rows, [1]), -1)
        best_corr = table[torch.arange(len(ref), device=self.dev), best]
        facing = -(normal[:, None, :] * self.optical).sum(-1)
        ratio = self.region_ratio(center, normal, ref, lod)
        is_best = torch.arange(C, device=self.dev) == best[:, None]
        drop = ((ratio < float(self.p["minRegionRatio"])) | (facing < 0)
                | (~is_best & (best_corr < float(self.p["minCorrelation"]))))
        return mask & drop
