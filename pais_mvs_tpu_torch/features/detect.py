"""DoG scale-space keypoint detection as a fixed-shape tensor program.

The PyTorch counterpart of ``pais_mvs_tpu/features/detect.py``. The
reference relies on OpenCV's SIFT detector (TMVS/mvs/featuremanager.cpp:
19-26). Here the scale space is built with separable Gaussian blurs, extrema
are found by 3x3 max/min pooling across adjacent DoG levels, and a fixed
top-K per octave keeps every shape static. Scores below threshold are
masked, never dropped, so the output is always [K, ...] + mask.

Two choices keep the result reproducible on the card, run after run:
  * the blur is a sum of shifted slices in tap order (no convolution
    library call, whose algorithm may change between runs);
  * top-K is a stable descending sort, so ties (most of the K slots of a
    sparse octave hold score 0) go to the lower flat index, the order
    ``jax.lax.top_k`` gives.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    xy: torch.Tensor         # [K, 2] level-0 pixel coords (x, y)
    sigma: torch.Tensor      # [K] scale (level-0 pixels)
    octave: torch.Tensor     # [K] int32
    score: torch.Tensor      # [K] |DoG| response
    mask: torch.Tensor       # [K] bool
    xy_oct: torch.Tensor     # [K, 2] octave-local pixel coords
    sigma_oct: torch.Tensor  # [K] octave-local scale
    level: torch.Tensor      # [K] int32 DoG level within octave (0..S-1)


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with edge-replicate padding. img: [H, W]."""
    k = torch.as_tensor(_gauss_kernel1d(sigma), device=img.device)
    n = k.shape[0]
    r = (n - 1) // 2
    H, W = img.shape
    # along W (the taps summed in order; the kernel is symmetric, so this
    # is XLA's VALID correlation), then along H
    x = F.pad(img[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    acc = x[:, 0:W] * k[0]
    for t in range(1, n):
        acc = acc + x[:, t:t + W] * k[t]
    x = F.pad(acc[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    acc = x[0:H] * k[0]
    for t in range(1, n):
        acc = acc + x[t:t + H] * k[t]
    return acc


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    # "SAME" 3x3 window with -inf outside, as reduce_window pads
    return F.max_pool2d(x[None, None], 3, 1, 1)[0, 0]


def _minpool3(x: torch.Tensor) -> torch.Tensor:
    return -_maxpool3(-x)


def _octave_extrema(dogs: List[torch.Tensor], contrast_thresh: float,
                    edge_ratio: float) -> torch.Tensor:
    """Per-level extrema score maps. dogs: list of [H, W]. Returns
    [S, H, W] where S = len(dogs) - 2; zero where not a keypoint."""
    out = []
    roll = torch.roll
    for l in range(1, len(dogs) - 1):
        d = dogs[l]
        trio_max = torch.maximum(torch.maximum(_maxpool3(dogs[l - 1]),
                                               _maxpool3(dogs[l + 1])),
                                 _maxpool3(d))
        trio_min = torch.minimum(torch.minimum(_minpool3(dogs[l - 1]),
                                               _minpool3(dogs[l + 1])),
                                 _minpool3(d))
        is_ext = (d >= trio_max) | (d <= trio_min)
        # 2x2 Hessian edge-response gate (Lowe's r-test); the shifts wrap,
        # as jnp.roll does
        dxx = roll(d, -1, 1) + roll(d, 1, 1) - 2 * d
        dyy = roll(d, -1, 0) + roll(d, 1, 0) - 2 * d
        dxy = 0.25 * (roll(roll(d, -1, 0), -1, 1)
                      + roll(roll(d, 1, 0), 1, 1)
                      - roll(roll(d, -1, 0), 1, 1)
                      - roll(roll(d, 1, 0), -1, 1))
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        r = edge_ratio
        not_edge = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
        score = torch.abs(d)
        ok = is_ext & not_edge & (score > contrast_thresh)
        # keep a 8px interior margin (descriptor support must fit)
        H, W = d.shape
        ys = torch.arange(H, device=d.device)[:, None]
        xs = torch.arange(W, device=d.device)[None, :]
        ok &= (xs >= 8) & (xs < W - 8) & (ys >= 8) & (ys < H - 8)
        out.append(torch.where(ok, score, torch.zeros_like(score)))
    return torch.stack(out, dim=0)


def detect_keypoints(img: torch.Tensor, num_octaves: int = 4,
                     scales: int = 3, k_per_octave: int = 192,
                     contrast_thresh: float = 0.01,
                     edge_ratio: float = 10.0):
    """Detect DoG keypoints on a [H, W] image with values in [0, 255], on
    the image's device.

    Returns (Keypoints, gaussians) where ``gaussians`` is the list of
    per-octave blurred stacks [S+3, Ho, Wo] the descriptor stage samples.
    """
    sigma0 = 1.6
    k = 2.0 ** (1.0 / scales)
    dev = img.device
    # a 0-dim divisor: the card divides, where a Python number would make
    # it multiply by 1/255 (features/describe.py's note)
    img = img.to(torch.float32) / torch.tensor(255.0, device=dev)

    base = _blur(img, math.sqrt(max(sigma0 ** 2 - 0.25, 0.01)))
    all_xy, all_sig, all_oct, all_score, all_mask = [], [], [], [], []
    all_xy_oct, all_sig_oct, all_level = [], [], []
    gaussians = []
    # the S level scales sigma0 * k^(l+1), computed once on the host so
    # every device indexes the same bits (pow differs by an ulp between
    # the CPU's and the card's libraries)
    sig_levels = (sigma0 * torch.pow(
        torch.tensor(k, dtype=torch.float32),
        torch.arange(1, scales + 1, dtype=torch.float32))).to(dev)
    for o in range(num_octaves):
        H, W = base.shape
        if o > 0 and (H < 32 or W < 32):
            break     # octave 0 always runs, even on tiny images
        gs = [base]
        for i in range(1, scales + 3):
            sp = sigma0 * (k ** (i - 1))
            sn = sigma0 * (k ** i)
            gs.append(_blur(gs[-1], math.sqrt(sn * sn - sp * sp)))
        gaussians.append(torch.stack(gs, dim=0))
        dogs = [gs[i + 1] - gs[i] for i in range(scales + 2)]
        score = _octave_extrema(dogs, contrast_thresh, edge_ratio)  # [S,H,W]

        vals, idx = torch.sort(score.reshape(-1), descending=True,
                               stable=True)
        vals, idx = vals[:k_per_octave], idx[:k_per_octave]
        lvl = idx // (H * W)
        yy = (idx % (H * W)) // W
        xx = idx % W
        # quadratic sub-pixel offset from the per-level DoG maps, indexing
        # (level, y, x) in ONE gather per tap (never a [K, H, W] plane per
        # keypoint)
        dstack = torch.stack(dogs, 0)                    # [S+2, H, W]
        l1 = lvl + 1
        xp = torch.clamp(xx + 1, 0, W - 1)
        xm = torch.clamp(xx - 1, 0, W - 1)
        yp = torch.clamp(yy + 1, 0, H - 1)
        ym = torch.clamp(yy - 1, 0, H - 1)
        d_xp = dstack[l1, yy, xp]
        d_xm = dstack[l1, yy, xm]
        d_yp = dstack[l1, yp, xx]
        d_ym = dstack[l1, ym, xx]
        c = dstack[l1, yy, xx]
        gx = 0.5 * (d_xp - d_xm)
        gy = 0.5 * (d_yp - d_ym)
        hxx = d_xp + d_xm - 2 * c
        hyy = d_yp + d_ym - 2 * c
        one = torch.ones_like(hxx)
        ox = torch.clamp(-gx / torch.where(torch.abs(hxx) > 1e-8, hxx, one),
                         -0.5, 0.5)
        oy = torch.clamp(-gy / torch.where(torch.abs(hyy) > 1e-8, hyy, one),
                         -0.5, 0.5)

        scale_mult = float(2 ** o)
        xy_oct = torch.stack([xx.to(torch.float32) + ox,
                              yy.to(torch.float32) + oy], -1)
        sig_oct = sig_levels[lvl]
        all_xy.append(xy_oct * scale_mult)
        all_sig.append(sig_oct * scale_mult)
        all_oct.append(torch.full((k_per_octave,), o, dtype=torch.int32,
                                  device=dev))
        all_score.append(vals)
        all_mask.append(vals > 0)
        all_xy_oct.append(xy_oct)
        all_sig_oct.append(sig_oct)
        all_level.append(lvl.to(torch.int32))
        base = gs[scales][::2, ::2]

    kp = Keypoints(
        xy=torch.cat(all_xy), sigma=torch.cat(all_sig),
        octave=torch.cat(all_oct), score=torch.cat(all_score),
        mask=torch.cat(all_mask), xy_oct=torch.cat(all_xy_oct),
        sigma_oct=torch.cat(all_sig_oct), level=torch.cat(all_level))
    return kp, gaussians
