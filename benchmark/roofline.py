"""K1's roofline bound on real arguments, and the card's peaks.

Frozen copy of ``chip_smoke.py`` at commit 04b33df: the peaks and K1's
operation constants (``chip_smoke.py:277-287``), ``touched_atlas_elements``
(``:435-469``) and ``k1_bound_ms`` (``:472-520``), with the window offsets
written out here (``ops/fitness.py::window_offsets``) so that nothing of
the program's arithmetic is imported. The arguments are those of the
program's K1 wrapper (``ops/cuda_fitness.py::score_windows``): the atlas
planes (``pyrs``: images, dims, yoff), H, pt, ref_cam, cam_mask, lod,
pvalid and active.
"""

from __future__ import annotations

import torch

# H100 SXM data-sheet peaks (dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# FP32 operations per (window pixel, visible camera) sample and per window
# pixel, counted from the kernel's arithmetic: homography 3 rows (6 mul +
# 6 add) + 2 divisions; fx/fy and 1-fx/1-fy (4); bilinear 8 mul + 3 add;
# mean 1 add; SAD sub + add (2) -> 32 per sample. Per pixel: window
# coordinates 2, mean/SAD divisions 2, difference weight 4 (mul, div, exp,
# mul), gradient weight 4 when enabled, foreground mask 1, sums 3.
K1_OPS_SAMPLE, K1_OPS_PIXEL, K1_OPS_GRAD = 32, 12, 4


def window_offsets(radius: int, device) -> torch.Tensor:
    """[W*W, 2] (dx, dy), x-major: offset k is (k // W - r, k % W - r)."""
    ax = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=device)
    dx, dy = torch.meshgrid(ax, ax, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)


def touched_atlas_elements(pyrs, H, pt, lod, cam_mask, keep, radius, lo,
                           hi_margin, rows=2048):
    """The distinct atlas elements the bilinear taps of a warp must read:
    only samples inside the margins, of visible cameras, of kept rows.
    H [N, C, 3, 3], pt [N, 2], lod [N], cam_mask [N, C], keep [N] bool."""
    C, Ha, Wa = pyrs.images.shape
    touched = torch.zeros(C * Ha * Wa, dtype=torch.bool, device=pt.device)
    offs = window_offsets(radius, pt.device)
    cam = torch.arange(C, device=pt.device)
    for s in range(0, pt.shape[0], rows):
        sl = slice(s, s + rows)
        win = pt[sl, None, :] + offs
        x, y = win[..., 0][..., None], win[..., 1][..., None]
        Hc = H[sl, None]
        w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
        sw = torch.where(w == 0, 1.0, w)
        u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
        v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
        dims = pyrs.dims[cam, lod[sl, None].long()].float()
        hgt, wid = dims[:, None, :, 0], dims[:, None, :, 1]
        ok = ((u >= lo) & (u < wid - hi_margin) & (v >= lo)
              & (v < hgt - hi_margin) & (w != 0)
              & cam_mask[sl, None, :] & keep[sl, None, None])
        yo = pyrs.yoff[lod[sl].long()][:, None, None]
        x0 = torch.floor(u).clamp(0, Wa - 2).long()
        y0 = (torch.floor(v).long() + yo).clamp(0, Ha - 2)
        i00 = (cam * (Ha * Wa) + y0 * Wa + x0)[ok]
        for d in (0, 1, Wa, Wa + 1):
            touched[i00 + d] = True
    return touched


def k1_bound_ms(pyrs, radius: int, gradient: bool, H, pt, ref, cam_mask,
                lod, pvalid, active):
    """K1's roofline bound on these inputs: (ms, "bytes" or "operations").
    Operations: the FP32 work of the kept particles (valid and in an
    active swarm). Bytes: the atlas elements their taps read (bilinear taps
    inside K1's margins, plus the nearest reference pixel of every window
    pixel in images and, with the gradient weight, in edges), H and pt of
    the kept particles, the small inputs whole, the output."""
    B, P, C = H.shape[:3]
    W2 = (2 * radius + 1) ** 2
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=H.device)
    keep = pvalid & active[:, None]
    live = keep.sum(1)
    ncam = cam_mask.sum(1)
    ops = float((live * W2 * (ncam * K1_OPS_SAMPLE + K1_OPS_PIXEL
                              + (K1_OPS_GRAD if gradient else 0))).sum())
    atlas = pyrs.images
    kept = keep.reshape(-1)
    img_t = touched_atlas_elements(
        pyrs, H.reshape(B * P, C, 3, 3), pt.reshape(B * P, 2),
        lod.repeat_interleave(P), cam_mask.repeat_interleave(P, 0), kept,
        radius, 2.0, 3.0)
    offs = window_offsets(radius, pt.device)
    win = pt.reshape(B * P, 1, 2)[kept] + offs
    Ha, Wa = atlas.shape[1:]
    lk = lod.repeat_interleave(P)[kept].long()[:, None]
    xi = torch.round(win[..., 0]).to(torch.int32).clamp(0, Wa - 1).long()
    yi = (torch.round(win[..., 1]).to(torch.int32).long()
          + pyrs.yoff[lk]).clamp(0, Ha - 1)
    ridx = (ref.repeat_interleave(P)[kept].long()[:, None] * (Ha * Wa)
            + yi * Wa + xi).reshape(-1)
    ref_t = torch.zeros_like(img_t)
    ref_t[ridx] = True
    n_img = int((img_t | ref_t).sum())
    n_edge = int(ref_t.sum()) if gradient else 0
    n_kept = int(kept.sum())
    nbytes = float((n_img + n_edge) * atlas.element_size()
                   + n_kept * (C * 9 + 2) * 4 + pvalid.numel()
                   + ref.numel() * 4 + lod.numel() * 4 + cam_mask.numel()
                   + active.numel() + W2 * 4 + B * P * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
