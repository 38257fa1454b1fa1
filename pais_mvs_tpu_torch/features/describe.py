"""Gradient-histogram descriptors on fixed sample grids.

The PyTorch counterpart of ``pais_mvs_tpu/features/describe.py``:
SIFT-style 4x4x8 = 128-d descriptors (the reference uses OpenCV SIFT,
TMVS/mvs/featuremanager.cpp:19-26) with no data-dependent shapes. Every
keypoint samples a fixed normalized grid scaled by its sigma and rotated by
its dominant orientation; where JAX ``vmap``s one keypoint, this module
carries the keypoint axis K through every tensor.

Both histograms are one-hot compares against ``arange(bins)`` times the
weights, summed over the samples: a plain reduction, so the sums (and the
orientation ``argmax`` that reads them) come out the same on every run. A
scatter-add would use atomics on the card, whose order varies.

Divisions by a constant go through ``_div``: on the card PyTorch multiplies
a tensor divided by a Python number by the number's reciprocal, which can
differ from the division in the last bit, and the orientation histogram
bins each sample whole on such bits. Dividing by a 0-dim tensor divides on
both devices.
"""

from __future__ import annotations

import math

import torch

_ORI_GRID = 9       # (2g+1)^2 orientation samples
_DESC_CELLS = 4     # 4x4 spatial cells
_DESC_SPC = 4       # samples per cell side -> 16x16 sample grid
_ORI_BINS = 36
_DESC_BINS = 8


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division on every device (see the module note)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _bilinear(gauss: torch.Tensor, level: torch.Tensor,
              xy: torch.Tensor) -> torch.Tensor:
    """Sample image ``level[k]`` of the [L, H, W] stack at xy [K, ..., 2]
    (x, y) with clamped bilinear; one gather per tap."""
    _, H, W = gauss.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    lv = level.to(torch.int64).reshape((-1,) + (1,) * (x.dim() - 1))
    v00 = gauss[lv, y0, x0]
    v01 = gauss[lv, y0, x0 + 1]
    v10 = gauss[lv, y0 + 1, x0]
    v11 = gauss[lv, y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _histogram(bins: torch.Tensor, weights: torch.Tensor,
               n: int) -> torch.Tensor:
    """[K, n] sums of ``weights`` [K, S] into ``bins`` [K, S] (ints in
    [0, n)), as a one-hot reduction over the samples."""
    ar = torch.arange(n, device=bins.device)
    onehot = bins[..., None] == ar
    return torch.where(onehot, weights[..., None],
                       torch.zeros((), device=weights.device)).sum(-2)


def _grid(n: int, offset: float, device) -> tuple:
    ax = torch.arange(n, dtype=torch.float32, device=device) + offset
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")   # jnp "xy" order
    return gx, gy


def orientation_histogram(gauss, level, xy, sigma):
    """The circularly smoothed [K, 36] gradient-orientation histogram
    around each keypoint (octave coords; xy [K, 2], sigma [K]) whose first
    peak is the keypoint's orientation."""
    g = _ORI_GRID
    step = 0.75
    gx, gy = _grid(2 * g + 1, -g, xy.device)
    gx, gy = gx * step, gy * step
    s = sigma[:, None, None, None]
    pts = xy[:, None, None, :] + s * torch.stack([gx, gy], -1)
    d = (0.5 * sigma * step)[:, None, None]
    zero = torch.zeros_like(d)
    ix1 = _bilinear(gauss, level, pts + torch.stack([d, zero], -1))
    ix0 = _bilinear(gauss, level, pts - torch.stack([d, zero], -1))
    iy1 = _bilinear(gauss, level, pts + torch.stack([zero, d], -1))
    iy0 = _bilinear(gauss, level, pts - torch.stack([zero, d], -1))
    dx = ix1 - ix0
    dy = iy1 - iy0
    mag = torch.sqrt(dx * dx + dy * dy)
    w = torch.exp(_div(-(gx * gx + gy * gy), 2.0 * (0.6 * g) ** 2))
    theta = torch.arctan2(dy, dx)                    # [-pi, pi]
    binf = _div(theta + math.pi, 2 * math.pi) * _ORI_BINS
    bins = torch.clamp(binf.to(torch.int32), 0, _ORI_BINS - 1)
    K = xy.shape[0]
    hist = _histogram(bins.reshape(K, -1), (mag * w).reshape(K, -1),
                      _ORI_BINS)
    # smooth the histogram circularly
    return _div(torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1),
                3.0)


def _orientation(gauss, level, xy, sigma):
    """Dominant gradient orientation around each keypoint: the centre of
    the smoothed histogram's (first) peak bin. -> [K]."""
    hist = orientation_histogram(gauss, level, xy, sigma)
    b = torch.argmax(hist, dim=-1)
    return (_div(b.to(torch.float32) + 0.5, _ORI_BINS) * 2 * math.pi
            - math.pi)


def _normalize(v):
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(norm > 0, norm, torch.ones_like(norm))


def _descriptor(gauss, level, xy, sigma, ori):
    """[K, 128] descriptors from rotated, sigma-scaled 16x16 sample
    grids."""
    n = _DESC_CELLS * _DESC_SPC                      # 16
    half = n / 2.0
    gx, gy = _grid(n, -half + 0.5, xy.device)        # [16, 16]
    spacing = (0.9 * sigma)[:, None, None]
    ca = torch.cos(ori)[:, None, None]
    sa = torch.sin(ori)[:, None, None]
    rx = (ca * gx - sa * gy) * spacing
    ry = (sa * gx + ca * gy) * spacing
    pts = xy[:, None, None, :] + torch.stack([rx, ry], -1)
    d = 0.5 * spacing
    # finite differences along the ROTATED axes give gradients already in
    # the keypoint frame (rotation invariance without angle subtraction)
    du = torch.stack([ca, sa], -1) * d[..., None]
    dv = torch.stack([-sa, ca], -1) * d[..., None]
    ix1 = _bilinear(gauss, level, pts + du)
    ix0 = _bilinear(gauss, level, pts - du)
    iy1 = _bilinear(gauss, level, pts + dv)
    iy0 = _bilinear(gauss, level, pts - dv)
    dxr = ix1 - ix0
    dyr = iy1 - iy0
    mag = torch.sqrt(dxr * dxr + dyr * dyr)
    w = torch.exp(_div(-(gx * gx + gy * gy), 2.0 * (0.5 * n) ** 2))
    theta = torch.arctan2(dyr, dxr)
    binf = _div(theta + math.pi, 2 * math.pi) * _DESC_BINS
    fl = torch.floor(binf)
    b0 = fl.to(torch.int32) % _DESC_BINS
    b1 = (b0 + 1) % _DESC_BINS
    f = binf - fl

    cell = ((gy + half - 0.5 + 1e-3).to(torch.int32) // _DESC_SPC
            * _DESC_CELLS
            + (gx + half - 0.5 + 1e-3).to(torch.int32) // _DESC_SPC)
    K = xy.shape[0]
    idx0 = (cell * _DESC_BINS + b0).reshape(K, -1)
    idx1 = (cell * _DESC_BINS + b1).reshape(K, -1)
    wm = (mag * w).reshape(K, -1)
    f = f.reshape(K, -1)
    nb = _DESC_CELLS * _DESC_CELLS * _DESC_BINS
    desc = (_histogram(idx0, wm * (1 - f), nb)
            + _histogram(idx1, wm * f, nb))
    desc = torch.minimum(_normalize(desc), torch.tensor(0.2,
                                                        device=xy.device))
    return _normalize(desc)


def describe_octave(gauss: torch.Tensor, xy_oct: torch.Tensor,
                    sigma_oct: torch.Tensor, level: torch.Tensor,
                    scales: int = 3) -> torch.Tensor:
    """Descriptors for keypoints of ONE octave.

    gauss: [S+3, Ho, Wo] blurred stack; xy_oct/sigma_oct in octave coords;
    level in [0, S) selects which blurred image to sample.
    Returns [K, 128] descriptors.
    """
    lv = torch.clamp(level + 1, 0, gauss.shape[0] - 1)
    ori = _orientation(gauss, lv, xy_oct, sigma_oct)
    return _descriptor(gauss, lv, xy_oct, sigma_oct, ori)
