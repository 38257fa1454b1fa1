"""Image pyramid construction (host-side, numpy, done once per scene).

Reproduces the reference camera's image preprocessing
(TMVS/mvs/camera.cpp:62-92):

* grayscale pyramid: level ``i`` is the level-0 image area-resampled by
  ``lodRatio**i`` (OpenCV INTER_AREA), quantized back to uint8;
* per-level "edge" image: Sobel (ksize=1) gradient magnitude, min-max
  normalized to [0, 1];
* ``maxLOD = log(max(w, h)) / log(1 / lodRatio)`` capped by config.

The per-camera pyramids are packed into one padded device array
``[num_cams, num_levels, Hmax, Wmax]`` so a single gather serves every
(patch, view, level) access on the TPU. Padding is zero, which doubles as
the reference's intensity-0 background convention.
"""

from __future__ import annotations

import math

import numpy as np


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> uint8 gray, BT.601 weights (OpenCV imread(,0))."""
    if img.ndim == 2:
        return img.astype(np.uint8)
    g = (0.299 * img[..., 0].astype(np.float64)
         + 0.587 * img[..., 1].astype(np.float64)
         + 0.114 * img[..., 2].astype(np.float64))
    return np.clip(np.round(g), 0, 255).astype(np.uint8)


def _antiderivative_axis0(img: np.ndarray):
    """(f, F) for `_area_resample_axis0`: f the float64 signal, F its
    running integral with F[0] = 0 (linear between integer positions).
    Split out so a pyramid build can compute the level-0 integral ONCE
    and share it across every level's resample (each full-res cumsum is
    ~0.1 s at 4K and the reference semantics resample every level from
    level 0, camera.cpp:69-92)."""
    f = img.astype(np.float64)
    F = np.concatenate([np.zeros((1, f.shape[1])),
                        np.cumsum(f, axis=0)], axis=0)
    return f, F


def _area_resample_axis0(img: np.ndarray, n_out: int, fF=None) -> np.ndarray:
    """Exact 1-D area (box-overlap) resampling along axis 0 — the
    arbitrary-scale INTER_AREA rule — via the antiderivative trick:
    the mean of a piecewise-constant signal over [lo, hi] is
    (F(hi) - F(lo)) / (hi - lo) with F its piecewise-LINEAR integral,
    evaluated with interpolation. O(n) per output row instead of the
    dense [n_out, n_in] weight matrix (which is minutes of host time at
    4K resolutions). ``fF``: optional precomputed `_antiderivative_axis0`
    of ``img``."""
    n_in = img.shape[0]
    f, F = _antiderivative_axis0(img) if fF is None else fF
    scale = n_in / n_out
    edges = np.arange(n_out + 1) * scale
    e0 = np.clip(np.floor(edges).astype(np.int64), 0, n_in)
    frac = (edges - e0)[:, None]
    # F at fractional positions (piecewise linear; clamp the last edge)
    Fe = F[e0] + frac * f[np.minimum(e0, n_in - 1)] * (e0 < n_in)[:, None]
    box = Fe[1:] - Fe[:-1]
    width = (edges[1:] - edges[:-1])[:, None]
    return box / width


def area_resize(img: np.ndarray, out_h: int, out_w: int, fF=None) -> np.ndarray:
    """Separable area resampling of a 2-D image (float64 out). ``fF``:
    optional precomputed axis-0 antiderivative of ``img``."""
    tmp = _area_resample_axis0(img, out_h, fF)
    return _area_resample_axis0(tmp.T, out_w).T


def sobel_magnitude(img: np.ndarray) -> np.ndarray:
    """Sobel ksize=1 gradient magnitude with reflect-101 borders, min-max
    normalized to [0, 1] (TMVS/mvs/camera.cpp:71-91)."""
    f = img.astype(np.float64)
    p = np.pad(f, 1, mode="reflect")  # numpy 'reflect' == OpenCV reflect-101
    gx = p[1:-1, 2:] - p[1:-1, :-2]
    gy = p[2:, 1:-1] - p[:-2, 1:-1]
    mag = np.sqrt(gx * gx + gy * gy)
    lo, hi = mag.min(), mag.max()
    if hi > lo:
        return (mag - lo) / (hi - lo)
    return np.zeros_like(mag)


def window_variance_map(img: np.ndarray, radius: int) -> np.ndarray:
    """Variance of the (2r+1)^2 window centered at each pixel, -1 where the
    window leaves the image.

    Replaces the reference's per-patch LOD texture scan
    (Patch::setLOD, TMVS/mvs/patch.cpp:566-591) with an O(1) lookup:
    identical statistics (population variance over every window pixel,
    no background masking), precomputed once per pyramid level with
    separable box sums.
    """
    h, w = img.shape
    k = 2 * radius + 1
    out = np.full((h, w), -1.0, dtype=np.float64)
    if h < k or w < k:
        return out.astype(np.float32)
    f = img.astype(np.float64)

    def box_sum(a):
        c = np.cumsum(np.cumsum(a, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])

    n = k * k
    s1 = box_sum(f)
    s2 = box_sum(f * f)
    var = s2 / n - (s1 / n) ** 2
    out[radius:h - radius, radius:w - radius] = np.maximum(var, 0.0)
    return out.astype(np.float32)


def max_lod_for(width: int, height: int, lod_ratio: float, cap: int) -> int:
    """Ref: TMVS/mvs/camera.cpp:63-64."""
    m = int(math.log(max(width, height)) / math.log(1.0 / lod_ratio))
    return min(m, cap)


def build_pyramid(gray0: np.ndarray, lod_ratio: float, max_lod: int):
    """Build gray + edge pyramids for one image.

    Returns (levels, edges, dims): lists of float32 arrays (gray quantized
    to integer values like the reference's uchar pyramid) and [L, 2] dims
    (h, w) per level.
    """
    h0, w0 = gray0.shape
    levels, edges, dims = [], [], []
    fF0 = None
    for i in range(max_lod + 1):
        if i == 0:
            g = gray0.astype(np.float64)
        else:
            if fF0 is None:
                fF0 = _antiderivative_axis0(gray0)
            s = lod_ratio ** i
            oh = max(int(round(h0 * s)), 1)
            ow = max(int(round(w0 * s)), 1)
            g = np.clip(np.round(area_resize(gray0, oh, ow, fF0)), 0, 255)
        levels.append(g.astype(np.float32))
        edges.append(sobel_magnitude(g).astype(np.float32))
        dims.append((g.shape[0], g.shape[1]))
    return levels, edges, np.asarray(dims, dtype=np.int32)


def atlas_offsets(per_cam_dims, num_levels):
    """Row offsets of the vertical mip-atlas bands.

    Every level occupies a horizontal band of the atlas (band height = max
    over cameras of that level's height, 8-row aligned so Pallas DMA slabs
    stay tile-aligned). Memory is sum(h_l) x W0 instead of the old
    L x H0 x W0 stack — ~2x less at lodRatio 0.8.

    Returns (yoff [L+1] int32 — band starts, last entry = total height,
    wmax int — 128-aligned atlas width).
    """
    C = len(per_cam_dims)
    yoff = np.zeros(num_levels + 1, dtype=np.int32)
    for l in range(num_levels):
        band = 0
        for c in range(C):
            if l < per_cam_dims[c].shape[0]:
                band = max(band, int(per_cam_dims[c][l, 0]))
        band = (band + 7) // 8 * 8
        yoff[l + 1] = yoff[l] + band
    wmax = max(int(d[0, 1]) for d in per_cam_dims)
    wmax = (wmax + 127) // 128 * 128
    return yoff, wmax


def pack_variance_maps(per_cam_vars, per_cam_dims, num_levels):
    """Pack per-level variance maps into the [C, Ha, Wa] atlas, padding
    with -1 (= window-out-of-bounds)."""
    C = len(per_cam_vars)
    yoff, wmax = atlas_offsets(per_cam_dims, num_levels)
    out = np.full((C, int(yoff[-1]), wmax), -1.0, dtype=np.float32)
    for c in range(C):
        for l, v in enumerate(per_cam_vars[c]):
            y0 = int(yoff[l])
            out[c, y0:y0 + v.shape[0], :v.shape[1]] = v
    return out


def pack_pyramids(per_cam_levels, per_cam_edges, per_cam_dims, num_levels):
    """Pack ragged per-camera pyramids into one vertical mip-atlas.

    Args:
      per_cam_levels / per_cam_edges: list (len C) of lists of 2-D float32.
      per_cam_dims: list of [L_c, 2] int arrays.
      num_levels: global L (>= every camera's level count).

    Returns:
      images [C, Ha, Wa] f32 (level l in rows [yoff[l], yoff[l]+h_l)),
      edges likewise, dims [C, L, 2] int32 (zero-sized for levels a camera
      does not have), yoff [L+1] int32 band offsets.
    """
    C = len(per_cam_levels)
    yoff, wmax = atlas_offsets(per_cam_dims, num_levels)
    ha = int(yoff[-1])
    images = np.zeros((C, ha, wmax), dtype=np.float32)
    edges = np.zeros((C, ha, wmax), dtype=np.float32)
    dims = np.zeros((C, num_levels, 2), dtype=np.int32)
    for c in range(C):
        for l, (g, e) in enumerate(zip(per_cam_levels[c], per_cam_edges[c])):
            h, w = g.shape
            y0 = int(yoff[l])
            images[c, y0:y0 + h, :w] = g
            edges[c, y0:y0 + h, :w] = e
            dims[c, l] = (h, w)
    return images, edges, dims, yoff
