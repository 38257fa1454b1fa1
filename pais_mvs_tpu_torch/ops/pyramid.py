"""Image pyramid construction (done once per scene).

Reproduces the reference camera's image preprocessing
(TMVS/mvs/camera.cpp:62-92), with the contract of the JAX package's numpy
build (``pais_mvs_tpu/ops/pyramid.py``):

* grayscale pyramid: level ``i`` is the level-0 image area-resampled by
  ``lodRatio**i`` (OpenCV INTER_AREA), quantized back to uint8;
* per-level "edge" image: Sobel (ksize=1) gradient magnitude, min-max
  normalized to [0, 1];
* per-level window-variance map (the LOD choice's texture test);
* ``maxLOD = log(max(w, h)) / log(1 / lodRatio)`` capped by config.

The per-camera pyramids are packed into one vertical mip-atlas per plane
(``[num_cams, Ha, Wa]`` bf16, see ``atlas_offsets``). Padding is zero
(-1 for the variance atlas), which doubles as the reference's intensity-0
background convention.

Every pixel step is one function here. On a CPU tensor it runs its plain
PyTorch body in float64 (the twin, bit-equal to the numpy build); on a CUDA
tensor it launches its kernel of ``csrc/pyramid.cu`` or raises (no
fallback). The twins keep numpy's order of operations; every running sum
runs sequentially along its line (``torch.cumsum`` on the CPU, one thread
per line in the kernels), so the card's atlases equal the CPU's bit for
bit. What needs no pixels (each level's size, the atlas layout) stays on
the host: ``level_dims``, ``atlas_offsets``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pais_mvs_tpu_torch.ops import cuda_fitness as CF

_F64 = torch.float64


def _out(like: torch.Tensor, shape, dtype=_F64) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def host_tensor(img: np.ndarray) -> torch.Tensor:
    """A uint8 CPU tensor of a decoded image, without a copy unless numpy
    marks the array read-only (as a PIL decode is): torch views only
    writable memory."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return torch.from_numpy(img if img.flags.writeable else img.copy())


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [H, W, 3] -> uint8 gray, BT.601 weights (OpenCV imread(,0));
    a gray [H, W] image passes through. The plain twin of the kernel
    ``gray_plane`` runs."""
    if img.ndim == 2:
        return img.to(torch.uint8)
    f = img.to(_F64)
    g = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    return torch.round(g).clamp(0, 255).to(torch.uint8)


def gray_plane(img: torch.Tensor, rgb_out: torch.Tensor) -> torch.Tensor:
    """The level-0 gray image of one uploaded camera image, as float64
    [H, W]; ``rgb_out`` ([Hmax, Wmax, 3] uint8, the camera's plane of the
    packed colour) gets the image in its top-left corner (a gray image on
    all three channels)."""
    h, w = img.shape[:2]
    if img.device.type == "cpu":
        rgb_out[:h, :w] = img if img.ndim == 3 else img[..., None]
        return rgb_to_gray(img).to(_F64)
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch not in (1, 3):
        raise ValueError(f"an image has 1 or 3 channels, got {ch}")
    hm, wm = rgb_out.shape[:2]
    if h > hm or w > wm:
        raise ValueError(f"a {h}x{w} image does not fit the {hm}x{wm} plane")
    out = _out(img, (h, w))
    CF._launch("pyramid_gray", CF._check("img", img, torch.uint8), h, w, ch,
               CF._check("rgb_out", rgb_out, torch.uint8, (hm, wm, 3)), wm,
               out.data_ptr())
    return out


def antiderivative(f: torch.Tensor) -> torch.Tensor:
    """Running integral along axis 0 with a leading zero row: F [n+1, W]
    of float64 f [n, W], F[0] = 0 (piecewise linear between integer
    positions). A pyramid build computes the level-0 integral ONCE and
    shares it across every level's resample (the reference resamples every
    level from level 0, camera.cpp:69-92)."""
    n, w = f.shape
    if f.device.type == "cpu":
        return torch.cat([f.new_zeros(1, w), torch.cumsum(f, 0)])
    out = _out(f, (n + 1, w))
    CF._launch("pyramid_col_scan", CF._check("f", f, _F64), n, w,
               out.data_ptr(), None)
    return out


def moment_antiderivative(g: torch.Tensor) -> torch.Tensor:
    """``antiderivative`` of g and of g * g, stacked: [2, n+1, W] (the
    window variance's first pass)."""
    n, w = g.shape
    if g.device.type == "cpu":
        return torch.stack([antiderivative(g), antiderivative(g * g)])
    out = _out(g, (2, n + 1, w))
    CF._launch("pyramid_col_scan", CF._check("g", g, _F64), n, w,
               out.data_ptr(), out[1].data_ptr())
    return out


def row_antiderivative(a: torch.Tensor) -> torch.Tensor:
    """Running integral along the last axis with a leading zero column:
    [..., n] -> [..., n+1] float64 (``antiderivative`` of the transpose)."""
    n = a.shape[-1]
    if a.device.type == "cpu":
        return torch.cat([a.new_zeros(*a.shape[:-1], 1),
                          torch.cumsum(a, -1)], -1)
    out = _out(a, (*a.shape[:-1], n + 1))
    CF._launch("pyramid_row_scan", CF._check("a", a, _F64), a.numel() // n,
               n, out.data_ptr())
    return out


def area_resample_axis0(f: torch.Tensor, F: torch.Tensor,
                        n_out: int) -> torch.Tensor:
    """Exact 1-D area (box-overlap) resampling of f [n_in, W] along axis 0
    — the arbitrary-scale INTER_AREA rule — via the antiderivative trick:
    the mean of a piecewise-constant signal over [lo, hi] is
    (F(hi) - F(lo)) / (hi - lo) with F (``antiderivative(f)``) its
    piecewise-LINEAR integral, evaluated with interpolation. O(n) per
    output row instead of the dense [n_out, n_in] weight matrix."""
    n_in = f.shape[0]
    scale = n_in / n_out
    edges = torch.arange(n_out + 1, dtype=_F64) * scale
    e0 = torch.floor(edges).to(torch.int64).clamp(0, n_in)
    frac = (edges - e0)[:, None]
    # F at fractional positions (piecewise linear; clamp the last edge)
    Fe = F[e0] + frac * f[e0.clamp(max=n_in - 1)] * (e0 < n_in)[:, None]
    box = Fe[1:] - Fe[:-1]
    width = (edges[1:] - edges[:-1])[:, None]
    return box / width


def area_resize(img: torch.Tensor, out_h: int, out_w: int,
                F: torch.Tensor = None) -> torch.Tensor:
    """Separable area resampling of a 2-D image (float64 out, not rounded).
    ``F``: optional precomputed ``antiderivative`` of ``img``."""
    f = img.to(_F64)
    tmp = area_resample_axis0(f, antiderivative(f) if F is None else F,
                              out_h)
    return area_resample_axis0(tmp.T, antiderivative(tmp.T), out_w).T


def resample_rows(f: torch.Tensor, F: torch.Tensor, n_out: int):
    """The axis-0 pass of ``area_resize``: f [n_in, W] float64 and its
    ``antiderivative`` F -> [n_out, W]."""
    if f.device.type == "cpu":
        return area_resample_axis0(f, F, n_out)
    n_in, w = f.shape
    out = _out(f, (n_out, w))
    CF._launch("pyramid_resample_rows", CF._check("f", f, _F64),
               CF._check("F", F, _F64, (n_in + 1, w)), n_in, w, n_out,
               out.data_ptr())
    return out


def resample_cols(tmp: torch.Tensor, G: torch.Tensor, n_out: int):
    """The axis-1 pass of ``area_resize`` with the level's quantization:
    tmp [H, n_in] float64 and its ``row_antiderivative`` G -> the level
    image [H, n_out], rounded half to even and clipped to 0..255."""
    if tmp.device.type == "cpu":
        return torch.round(area_resample_axis0(tmp.T, G.T, n_out).T
                           ).clamp(0, 255)
    h, n_in = tmp.shape
    out = _out(tmp, (h, n_out))
    CF._launch("pyramid_resample_cols", CF._check("tmp", tmp, _F64),
               CF._check("G", G, _F64, (h, n_in + 1)), h, n_in, n_out,
               out.data_ptr())
    return out


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's 'reflect' (OpenCV reflect-101) index one step outside
    [0, n); a single pixel reflects onto itself."""
    if n == 1:
        return torch.zeros_like(i)
    return torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))


# the largest squared Sobel magnitude of a level image (integers 0..255)
_SQ_MAX = 2 * 255 * 255


@functools.lru_cache(maxsize=1)
def _sqrt_table() -> torch.Tensor:
    """sqrt(n) for every n in 0.._SQ_MAX, correctly rounded (Python's
    math.sqrt is IEEE-754's). torch's CPU sqrt is not: in float64 it
    misses the nearest double on about 0.5% of these integers."""
    return torch.tensor([math.sqrt(n) for n in range(_SQ_MAX + 1)],
                        dtype=_F64)


def _sobel_raw(f: torch.Tensor) -> torch.Tensor:
    """Sobel ksize=1 gradient magnitude of float64 f with reflect-101
    borders (central differences), not normalized. f is a level image
    (integers 0..255), so the squared magnitude is an integer and its
    root comes exact from ``_sqrt_table``."""
    h, w = f.shape
    ys, xs = torch.arange(h), torch.arange(w)
    gx = f[:, _reflect(xs + 1, w)] - f[:, _reflect(xs - 1, w)]
    gy = f[_reflect(ys + 1, h)] - f[_reflect(ys - 1, h)]
    sq = gx * gx + gy * gy
    n = sq.to(torch.int64)
    if not torch.equal(n.to(_F64), sq) or int(n.max()) > _SQ_MAX:
        raise ValueError("the Sobel magnitude takes level images: integers "
                         "0..255")
    return _sqrt_table()[n]


def _normalize(mag: torch.Tensor, lo, hi) -> torch.Tensor:
    if hi > lo:
        return (mag - lo) / (hi - lo)
    return torch.zeros_like(mag)


def sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Sobel ksize=1 gradient magnitude with reflect-101 borders, min-max
    normalized to [0, 1] (TMVS/mvs/camera.cpp:71-91); float64."""
    mag = _sobel_raw(img.to(_F64))
    return _normalize(mag, mag.min(), mag.max())


def edge_range(g: torch.Tensor) -> torch.Tensor:
    """(min, max) of the level's Sobel magnitude, float64 [2]: the
    normalization of its edge plane (exact in any order)."""
    if g.device.type == "cpu":
        mag = _sobel_raw(g)
        return torch.stack([mag.min(), mag.max()])
    h, w = g.shape
    out = _out(g, (2,))
    CF._launch("pyramid_edge_range", CF._check("g", g, _F64), h, w,
               out.data_ptr())
    return out


def box_variance(I: torch.Tensor, radius: int) -> torch.Tensor:
    """The window-variance map from the level's moment integrals
    ``I = row_antiderivative(moment_antiderivative(g))`` [2, h+1, w+1]:
    float32 [h, w], -1 where the (2r+1)^2 window leaves the image."""
    h, w = I.shape[1] - 1, I.shape[2] - 1
    k = 2 * radius + 1
    out = torch.full((h, w), -1.0, dtype=_F64)
    if h < k or w < k:
        return out.float()

    def box_sum(c):
        return c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]

    n = k * k
    s1, s2 = box_sum(I[0]), box_sum(I[1])
    m = s1 / n
    var = s2 / n - m * m
    out[radius:h - radius, radius:w - radius] = var.clamp_min(0.0)
    return out.float()


def window_variance_map(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Variance of the (2r+1)^2 window centered at each pixel, -1 where the
    window leaves the image (float32).

    Replaces the reference's per-patch LOD texture scan
    (Patch::setLOD, TMVS/mvs/patch.cpp:566-591) with an O(1) lookup:
    identical statistics (population variance over every window pixel,
    no background masking), precomputed once per pyramid level with
    separable box sums.
    """
    f = img.to(_F64)
    return box_variance(row_antiderivative(moment_antiderivative(f)), radius)


def _bf16(a: torch.Tensor) -> torch.Tensor:
    # float64 -> float32 -> bf16, each to nearest even, as the JAX package
    # casts its float32 atlases
    return a.float().to(torch.bfloat16)


def pack_level(g, lohi, I, radius: int, y0: int, images, edges, var):
    """Write one level of one camera into its band of the three bf16
    atlas planes ([Ha, Wa] each, rows ``y0 .. y0 + h``): the image g, its
    edge plane normalized by ``lohi`` (``edge_range``) and its window-
    variance map from ``I`` (``box_variance``'s input). The planes come
    zeroed (-1 for ``var``); what lies outside [h, w] is left as it is."""
    h, w = g.shape
    if g.device.type == "cpu":
        band = (slice(y0, y0 + h), slice(0, w))
        images[band] = _bf16(g)
        edges[band] = _bf16(_normalize(_sobel_raw(g), lohi[0], lohi[1]))
        var[band] = _bf16(box_variance(I, radius))
        return
    Ha, Wa = images.shape
    if y0 + h > Ha or w > Wa:
        raise ValueError(f"a {h}x{w} level at row {y0} leaves the "
                         f"{Ha}x{Wa} atlas")
    CF._launch("pyramid_pack", CF._check("g", g, _F64), h, w,
               CF._check("lohi", lohi, _F64, (2,)),
               CF._check("I", I, _F64, (2, h + 1, w + 1)), radius, y0,
               *(CF._check(n, t, torch.bfloat16, (Ha, Wa))
                 for n, t in (("images", images), ("edges", edges),
                              ("var", var))), Wa)


def build_camera(img: torch.Tensor, dims: np.ndarray, radius: int, yoff,
                 images, edges, var, rgb) -> None:
    """One camera's atlas planes from its image ([H, W, 3] or [H, W]
    uint8, on the scene's device): the colour plane, then per level
    ``dims[l] = (h, w)`` its image, edge plane and variance map, packed at
    ``yoff[l]``. Level 0 is the gray image; every deeper level is
    area-resampled from level 0 through its shared integral."""
    gray = gray_plane(img, rgb)
    F = None
    for l, (h, w) in enumerate(np.asarray(dims).tolist()):
        if l == 0:
            g = gray
        else:
            if F is None:
                F = antiderivative(gray)
            tmp = resample_rows(gray, F, h)
            g = resample_cols(tmp, row_antiderivative(tmp), w)
        I = row_antiderivative(moment_antiderivative(g))
        pack_level(g, edge_range(g), I, radius, int(yoff[l]), images, edges,
                   var)


def max_lod_for(width: int, height: int, lod_ratio: float, cap: int) -> int:
    """Ref: TMVS/mvs/camera.cpp:63-64."""
    m = int(math.log(max(width, height)) / math.log(1.0 / lod_ratio))
    return min(m, cap)


def level_dims(h0: int, w0: int, lod_ratio: float, max_lod: int):
    """[max_lod + 1, 2] int32 (h, w) of every level of an h0 x w0 image,
    as the JAX package's ``build_pyramid`` sizes them."""
    dims = [(h0, w0)]
    for i in range(1, max_lod + 1):
        s = lod_ratio ** i
        dims.append((max(int(round(h0 * s)), 1), max(int(round(w0 * s)), 1)))
    return np.asarray(dims, dtype=np.int32)


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
