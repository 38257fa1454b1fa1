"""Batched adaptively-weighted photoconsistency scoring: the plain PyTorch
versions.

The PyTorch counterpart of ``pais_mvs_tpu/ops/fitness.py``, which is the
semantic reference for both kernels of this package. The reference
evaluates the score one candidate at a time inside each particle's OpenMP
thread (``PAIS::getFitness``, TMVS/mvs/patch.cpp:914-1047); here it is one
tensor program over ``[B, P]`` (patches x particles).

Each scoring function is split where its kernel begins:
  * ``fitness_geometry`` / ``warp_geometry``: per-particle homographies,
    reference-window centres and validity;
  * ``score_windows`` / ``warped_samples`` / ``view_moments`` /
    ``view_deviation``: the pixel work.
``fitness_geometry`` and the pixel stages are the plain twins of the CUDA
kernels in ``ops/cuda_fitness.py``. They run for CPU tensors, and
``chip_smoke.py`` holds each kernel against its twin. The view twins are
built from the view path's sampling stage, ``warped_samples_view`` and
``reference_windows``.

Semantics matched to the reference:
  * candidate = (theta, phi, depth) against a fixed (ref cam, cam set, LOD);
  * normals facing away from the reference camera are rejected (patch.cpp:939);
  * window bound margins: reference image [2, dim-3), warped views [2, dim-3)
    (patch.cpp:957-962, 999);
  * per-pixel mean over visible cameras, avgSAD = mean |c_i - mean|;
  * weight = gaussian-distance x exp(-sad^2/diffW) x exp(-1/(edge*gradW)),
    each factor gated by its adaptive-enable flag (patch.cpp:1029-1038);
  * intensity-0 reference pixels are background and contribute nothing
    (patch.cpp:986);
  * any out-of-bounds warp or degenerate homography kills the candidate
    (returns BIG, the reference's DBL_MAX).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.ops import geometry as geom
from pais_mvs_tpu_torch.ops.geometry import BIG

# sentinel of the warped-window sampler for samples outside the margins
INVALID = -1e9


def window_offsets(patch_radius: int) -> np.ndarray:
    """[W*W, 2] (dx, dy) offsets, x-major to mirror the reference's loop
    order (patch.cpp:979-980): offset k is (k // W - r, k % W - r)."""
    r = patch_radius
    ax = np.arange(-r, r + 1, dtype=np.float32)
    dx, dy = np.meshgrid(ax, ax, indexing="ij")
    return np.stack([dx.ravel(), dy.ravel()], axis=-1)


def dist_weight_table(cfg: MvsConfig) -> np.ndarray:
    """Normalized Gaussian distance weights, flattened x-major.
    Ref: MVS::initPatchDistanceWeighting (TMVS/mvs/mvs.cpp:97-114)."""
    r = cfg.patch_radius
    sigma = cfg.dist_weighting
    ax = np.arange(-r, r + 1, dtype=np.float64)
    dx, dy = np.meshgrid(ax, ax, indexing="ij")
    g = np.exp(-(dx ** 2 + dy ** 2) / (2.0 * sigma ** 2))
    g = g / (2.0 * np.pi * sigma ** 2)
    g = g / g.sum()
    return g.ravel().astype(np.float32)


@functools.lru_cache(maxsize=32)
def _offsets_on(radius: int, device: torch.device) -> torch.Tensor:
    # cached: a fresh host->device copy per call would stall the stream
    return torch.as_tensor(window_offsets(radius), device=device)


@functools.lru_cache(maxsize=32)
def dist_table_on(radius: int, sigma: float,
                  device: torch.device) -> torch.Tensor:
    """``dist_weight_table`` as a tensor on ``device`` (cached per device)."""
    cfg = MvsConfig(patch_radius=radius, dist_weighting=sigma)
    return torch.as_tensor(dist_weight_table(cfg), device=device)


def bilinear_gather(images, yoff, cam, lod, xy, dims, lo: float,
                    hi_margin: float):
    """Bilinear-sample the mip-atlas pyramids with bounds validity.

    Args:
      images: [C, Ha, Wa] packed mip-atlas (bf16).
      yoff: [L+1] int32 atlas band row offsets.
      cam, lod: int tensors broadcastable against each other and xy[..., 0].
      xy: [..., 2] sample positions (LEVEL-LOCAL coordinates).
      dims: [C, L, 2] per-level (h, w).
      lo / hi_margin: valid iff lo <= p < dim - hi_margin (reference uses
        (2, 3) in the fitness kernel and (0, 1) in the NCC warp).

    Returns: (values [...] f32, valid [...] bool).
    """
    C, Ha, Wa = images.shape
    flat = images.reshape(-1)
    h = dims[cam, lod, 0].float()
    w = dims[cam, lod, 1].float()
    ix, iy = xy[..., 0], xy[..., 1]
    valid = ((ix >= lo) & (ix < w - hi_margin) &
             (iy >= lo) & (iy < h - hi_margin) &
             torch.isfinite(ix) & torch.isfinite(iy))
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = ix - x0
    fy = iy - y0
    # clip BEFORE indexing: an out-of-range index faults in torch (NaN and
    # inf coordinates convert to arbitrary ints, which the clip bounds)
    x0i = torch.clamp(x0.to(torch.int32), 0, Wa - 2).long()
    y0i = torch.clamp(y0.to(torch.int32) + yoff[lod], 0, Ha - 2).long()
    idx00 = cam.long() * (Ha * Wa) + y0i * Wa + x0i
    v00 = flat[idx00]
    v01 = flat[idx00 + 1]
    v10 = flat[idx00 + Wa]
    v11 = flat[idx00 + Wa + 1]
    # bf16 taps times f32 weights promote to f32, as in the JAX package
    val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return val, valid


def nearest_gather(images, yoff, cam, lod, xy):
    """Round-to-nearest sample (for background/edge lookups, which the
    reference does with cvRound; in-bounds is the caller's invariant).
    Returns the atlas dtype."""
    C, Ha, Wa = images.shape
    flat = images.reshape(-1)
    xi = torch.clamp(torch.round(xy[..., 0]).to(torch.int32), 0, Wa - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).to(torch.int32) + yoff[lod],
                     0, Ha - 1)
    idx = cam.long() * (Ha * Wa) + yi.long() * Wa + xi.long()
    return flat[idx]


def _per_camera_homographies(scene, center, normal, ref_cam, lod_scale):
    """H[..., C, 3, 3] mapping ref-LOD pixels into each camera's LOD image.
    The reference camera's entry is pinned to exact identity
    (patch.cpp:316-319)."""
    rig = scene.rig
    C = rig.num_cameras
    H, ok = geom.plane_homography(
        center[..., None, :], normal[..., None, :],
        rig.R[ref_cam][..., None, :, :], rig.T[ref_cam][..., None, :],
        rig.focal[ref_cam][..., None, :], rig.principal[ref_cam][..., None, :],
        rig.R, rig.T, rig.focal, rig.principal,
        lod_scale[..., None])
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    is_ref = torch.arange(C, device=H.device) == ref_cam[..., None]
    H = torch.where(is_ref[..., None, None], eye, H)
    ok = ok | is_ref
    return H, ok


def lod_scale_of(cfg: MvsConfig, lod):
    """lodRatio**LOD per patch, in f32 (the base is made on the device: a
    host-to-device copy per PSO step would stall the stream)."""
    lodf = lod.float()
    return torch.pow(torch.full_like(lodf, cfg.lod_ratio), lodf)


def _project_ref(scene, X, ref_cam, lod_scale):
    """Project X [B, ..., 3] into each row's reference camera at its LOD."""
    rig = scene.rig
    extra = (None,) * (X.dim() - 2)
    sel = lambda a: a[ref_cam][(slice(None),) + extra]
    s = lod_scale[(slice(None),) + extra]
    return geom.project(X, sel(rig.R), sel(rig.T), sel(rig.focal),
                        sel(rig.principal), s)[0]


# ---------------------------------------------------------------------------
# photoconsistency fitness (K1's contract)
# ---------------------------------------------------------------------------

def fitness_geometry(scene, cfg: MvsConfig, ref_cam, cam_mask, lod, ray, pos):
    """Per-particle geometry of ``patch_fitness``.

    Returns (H [B, P, C, 3, 3], pt [B, P, 2] reference-window centres at the
    LOD, pvalid [B, P]: the normal faces the reference camera, the window
    lies inside the reference frame, and every visible camera's homography
    is well-defined)."""
    rig, pyrs = scene.rig, scene.pyramids
    B, P, _ = pos.shape

    normal = geom.spherical_to_normal(pos[..., :2])          # [B, P, 3]
    ref_center = rig.center[ref_cam]                          # [B, 3]
    center = ray[:, None, :] * pos[..., 2:3] + ref_center[:, None, :]

    # reject normals facing away from the reference camera (patch.cpp:939)
    facing_bad = (normal * rig.optical[ref_cam][:, None, :]).sum(-1) > 0

    lod_scale = lod_scale_of(cfg, lod)
    H, hok = _per_camera_homographies(
        scene, center, normal, ref_cam[:, None].expand(B, P),
        lod_scale[:, None].expand(B, P))
    pt = _project_ref(scene, center, ref_cam, lod_scale)      # [B, P, 2]

    r = cfg.patch_radius
    ref_dims = pyrs.dims[ref_cam, lod].float()                # [B, 2] (h, w)
    in_ref = ((pt[..., 0] - r >= 2) & (pt[..., 0] + r < ref_dims[:, None, 1] - 3) &
              (pt[..., 1] - r >= 2) & (pt[..., 1] + r < ref_dims[:, None, 0] - 3))
    pvalid = (~facing_bad & in_ref &
              torch.all(hok | ~cam_mask[:, None, :], dim=-1))
    return H, pt, pvalid


def score_windows(pyrs, cfg: MvsConfig, H, pt, ref_cam, cam_mask, lod,
                  pvalid, active=None):
    """Plain twin of the fused fitness kernel: score every particle's
    warped window. Scores the rows of the ``active`` swarms (all when
    None) and gives the others BIG, as the kernel does, so that the work
    follows the live swarms (a refine's budget is mostly invalid rows).
    Each row's score does not depend on the others.

    H [B, P, C, 3, 3], pt [B, P, 2], pvalid [B, P] -> fitness [B, P] f32."""
    out = torch.full(pvalid.shape, BIG, dtype=torch.float32,
                     device=pt.device)
    rows = (torch.arange(out.shape[0], device=pt.device) if active is None
            else torch.nonzero(active)[:, 0])
    if rows.numel():
        out[rows] = _score_rows(pyrs, cfg, H[rows], pt[rows], ref_cam[rows],
                                cam_mask[rows], lod[rows], pvalid[rows])
    return out


def _score_rows(pyrs, cfg: MvsConfig, H, pt, ref_cam, cam_mask, lod,
                pvalid):
    """``score_windows`` on every row."""
    B, P, C = H.shape[:3]
    r = cfg.patch_radius
    offs = _offsets_on(r, pt.device)                          # [W2, 2]
    win = pt[:, :, None, :] + offs                            # [B, P, W2, 2]

    # background skip: reference-image intensity at the rounded window pixel
    ref_b = ref_cam[:, None, None]
    lod_b = lod[:, None, None]
    ref_int = nearest_gather(pyrs.images, pyrs.yoff, ref_b, lod_b, win)
    fg = ref_int != 0                                         # [B, P, W2]

    # warp into every camera
    x = win[..., 0][..., None]                                # [B, P, W2, 1]
    y = win[..., 1][..., None]
    Hc = H[:, :, None, :, :, :]                               # [B, P, 1, C, 3, 3]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = torch.where(w == 0, 1.0, w)
    u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    uv = torch.stack([u, v], dim=-1)                          # [B, P, W2, C, 2]

    cam_idx = torch.arange(C, dtype=torch.int32, device=pt.device)
    vals, vok = bilinear_gather(pyrs.images, pyrs.yoff, cam_idx,
                                lod[:, None, None, None], uv, pyrs.dims,
                                2.0, 3.0)
    vok = vok & (w != 0)

    m = cam_mask[:, None, None, :]                            # [B, 1, 1, C]
    mf = m.to(vals.dtype)
    cn = cam_mask.sum(-1).to(vals.dtype)[:, None, None]
    mean = (vals * mf).sum(-1) / cn                           # [B, P, W2]
    sad = (torch.abs(vals - mean[..., None]) * mf).sum(-1) / cn

    # any visible camera's warp out of bounds on a foreground pixel kills the
    # candidate (the reference returns DBL_MAX on the first overflow)
    pix_ok = torch.all(vok | ~m, dim=-1)                      # [B, P, W2]
    cand_ok = torch.all(pix_ok | ~fg, dim=-1) & pvalid        # [B, P]

    weight = torch.ones_like(sad)
    if cfg.adaptive_distance_enable:
        weight = weight * dist_table_on(r, cfg.dist_weighting, pt.device)
    if cfg.adaptive_difference_enable:
        weight = weight * torch.exp(-sad * sad / cfg.diff_weighting)
    if cfg.adaptive_gradient_enable:
        # .float() first: bf16 times a Python float would stay bf16 in torch
        edge = nearest_gather(pyrs.edges, pyrs.yoff, ref_b, lod_b, win).float()
        safe_edge = torch.clamp(edge * cfg.gradient_weighting, min=1e-20)
        weight = weight * torch.exp(-1.0 / safe_edge)

    wfg = weight * fg.to(weight.dtype)
    sum_w = wfg.sum(-1)
    fit = (wfg * sad).sum(-1) / torch.where(sum_w > 0, sum_w, 1.0)
    return torch.where(cand_ok & (sum_w > 0), fit, BIG)


def patch_fitness(scene, cfg: MvsConfig, ref_cam, cam_mask, lod, ray, pos,
                  active=None):
    """Score candidate hypotheses.

    Args:
      scene: Scene (rig + pyramids); cfg: MvsConfig.
      ref_cam: [B] int32; cam_mask: [B, C] bool; lod: [B] int32;
      ray: [B, 3] unit rays from the reference cameras;
      pos: [B, P, 3] (theta, phi, depth) hypotheses.
      active: [B] bool or None — swarms whose result is used (a kernel
        may return BIG for the others).

    Returns: [B, P] f32 fitness (lower better; BIG = rejected).
    """
    H, pt, pvalid = fitness_geometry(scene, cfg, ref_cam, cam_mask, lod,
                                     ray, pos)
    return score_windows(scene.pyramids, cfg, H, pt, ref_cam, cam_mask, lod,
                         pvalid, active)


# ---------------------------------------------------------------------------
# warped window vectors for the NCC table (K2's contract)
# ---------------------------------------------------------------------------

def warp_geometry(scene, cfg: MvsConfig, center, normal, ref_cam, lod):
    """(H [B, C, 3, 3], hok [B, C], pt [B, 2]) for one window per patch."""
    lod_scale = lod_scale_of(cfg, lod)
    H, hok = _per_camera_homographies(scene, center, normal, ref_cam,
                                      lod_scale)
    pt = _project_ref(scene, center, ref_cam, lod_scale)
    return H, hok, pt


def warped_samples(pyrs, H, pt, lod, cam_mask, radius: int):
    """Plain twin of the warped-window sampler kernel: bilinear samples of
    every (patch, camera, window pixel), INVALID outside the margins
    [0, dim-1), where the homography's w is 0, or for a masked camera.

    H [B, C, 3, 3], pt [B, 2], lod [B], cam_mask [B, C] -> [B, C, W2] f32."""
    B, C = cam_mask.shape
    offs = _offsets_on(radius, pt.device)
    win = pt[:, None, :] + offs                               # [B, W2, 2]
    x = win[..., 0][..., None]                                # [B, W2, 1]
    y = win[..., 1][..., None]
    Hc = H[:, None, :, :, :]                                  # [B, 1, C, 3, 3]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = torch.where(w == 0, 1.0, w)
    u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    uv = torch.stack([u, v], dim=-1)                          # [B, W2, C, 2]
    cam_idx = torch.arange(C, dtype=torch.int32, device=pt.device)
    vals, vok = bilinear_gather(pyrs.images, pyrs.yoff, cam_idx,
                                lod[:, None, None], uv, pyrs.dims, 0.0, 1.0)
    vok = vok & (w != 0) & cam_mask[:, None, :]
    return torch.where(vok, vals, INVALID).transpose(1, 2).contiguous()


def warped_samples_view(pyrs, H, pt, lod, act, pvalid, radius: int):
    """The view path's sampling stage (the Pallas sampler's view mode, which
    ``view_moments`` and ``view_deviation`` build on): bilinear samples of
    every (patch, camera, particle, window pixel) with the fitness margins,
    INVALID outside [2, dim-3), where w is 0, or where ``act`` (patch,
    camera) or ``pvalid`` (patch, particle) is False. The sampling stage of
    pais_mvs_tpu/ops/view_fitness.py::fitness_view_jnp (:145-160) on a
    camera block (``pyrs`` holds the block and its dims).

    H [B, P, C, 3, 3], pt [B, P, 2], lod [B], act [B, C], pvalid [B, P]
    -> [B, C, P, W2] f32."""
    C = H.shape[2]
    offs = _offsets_on(radius, pt.device)
    win = pt[:, :, None, :] + offs                            # [B, P, W2, 2]
    x = win[..., 0][..., None]                                # [B, P, W2, 1]
    y = win[..., 1][..., None]
    Hc = H[:, :, None, :, :, :]                               # [B, P, 1, C, 3, 3]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = torch.where(w == 0, 1.0, w)
    u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    uv = torch.stack([u, v], dim=-1)                          # [B, P, W2, C, 2]
    cam_idx = torch.arange(C, dtype=torch.int32, device=pt.device)
    vals, vok = bilinear_gather(pyrs.images, pyrs.yoff, cam_idx,
                                lod[:, None, None, None], uv, pyrs.dims,
                                2.0, 3.0)
    vok = (vok & (w != 0) & act[:, None, None, :]
           & pvalid[:, :, None, None])
    return torch.where(vok, vals, INVALID).permute(0, 3, 1, 2).contiguous()


def reference_windows(pyrs, pt, ref_cam, own, lod, radius: int,
                      edges: bool):
    """The view path's reference-window reads (``view_moments``' planes 2
    and 3): the reference camera's intensity and, with ``edges``, its edge
    weight at the nearest pixel (per-pixel round(pt + offset)) of every
    window pixel, as pais_mvs_tpu/ops/view_fitness.py::fitness_view_jnp
    reads them (:135-143, :185-187); 0 in the rows of patches whose
    reference camera this rank does not hold (``where``, so nothing of
    those rows leaks).

    pt [B, P, 2], ref_cam [B] (an index into ``pyrs``' cameras, valid on
    every row), own [B] bool, lod [B] -> [n, B, P, W2] f32, n = 2 with
    ``edges`` (intensity, edge weight), else 1."""
    win = pt[:, :, None, :] + _offsets_on(radius, pt.device)  # [B, P, W2, 2]
    cam, lod_b = ref_cam[:, None, None], lod[:, None, None]
    own_b = own[:, None, None]
    atlases = (pyrs.images, pyrs.edges) if edges else (pyrs.images,)
    return torch.stack([
        torch.where(own_b, nearest_gather(a, pyrs.yoff, cam, lod_b,
                                          win).float(), 0.0)
        for a in atlases])


def view_moments(pyrs, H, pt, lod, act, cam_mask, pvalid, ref_cam, own,
                 radius: int, edges: bool):
    """Plain twin of the view fitness's first kernel: what
    pais_mvs_tpu/ops/view_fitness.py::fitness_view_jnp psums first
    (:135-143, :162-172, :185-187), on a camera block, per window pixel of
    every (patch, particle):

      plane 0: the valid samples of ``warped_samples_view``, added in
        camera order;
      plane 1: the cameras of ``cam_mask`` whose sample is invalid (outside
        [2, dim-3), w = 0, or ``act`` or ``pvalid`` off), as f32;
      plane 2 (and 3 with ``edges``): ``reference_windows``.

    H [B, P, c, 3, 3], pt [B, P, 2], lod [B], act / cam_mask [B, c],
    pvalid [B, P], ref_cam [B] (an index into the block), own [B]
    -> [n, B, P, W2] f32, n = 4 with ``edges``, else 3."""
    vals = warped_samples_view(pyrs, H, pt, lod, act, pvalid, radius)
    vok = vals > INVALID / 2                                  # [B, c, P, W2]
    total = torch.zeros_like(vals[:, 0])
    bad = torch.zeros_like(total)
    for c in range(vals.shape[1]):
        total = total + torch.where(vok[:, c], vals[:, c], 0.0)
        bad = bad + (cam_mask[:, c, None, None] & ~vok[:, c]).to(bad.dtype)
    return torch.cat([torch.stack([total, bad]),
                      reference_windows(pyrs, pt, ref_cam, own, lod, radius,
                                        edges)])


def view_deviation(pyrs, H, pt, lod, act, pvalid, mean, radius: int):
    """Plain twin of the view fitness's second kernel: per window pixel of
    every (patch, particle), |sample - mean| summed in camera order over
    the block's valid samples (fitness_view_jnp's SAD term, :170-171,
    before its psum); 0 where ``pvalid`` or every ``act`` is off.

    ``mean`` [B, P, W2] is the global per-pixel mean; the other arguments
    as ``view_moments`` -> [B, P, W2] f32."""
    vals = warped_samples_view(pyrs, H, pt, lod, act, pvalid, radius)
    vok = vals > INVALID / 2
    dev = torch.zeros_like(mean)
    for c in range(vals.shape[1]):
        dev = dev + torch.where(vok[:, c], (vals[:, c] - mean).abs(), 0.0)
    return dev


def warped_patch_vectors(scene, cfg: MvsConfig, center, normal, ref_cam,
                         cam_mask, lod, sampler=warped_samples):
    """L2-normalized warped window vectors for the correlation table.

    Ref: Patch::getHomographyPatch + setCorrelationTable
    (TMVS/mvs/patch.cpp:221-267, 332-386). Bounds are the looser [0, dim-1)
    of that path; an out-of-bounds warp in ANY visible camera marks the
    whole patch for dropping (the reference sets ``drop``).

    Args:
      center [B, 3], normal [B, 3], ref_cam [B], cam_mask [B, C], lod [B];
      sampler: the sampling stage (``warped_samples`` here; the dispatching
        wrapper in ``ops/cuda_fitness.py`` on the engine's path).

    Returns:
      vectors [B, C, W2] unit L2 rows (zero for masked cameras and invalid
      samples), corr [B, C, C] NCC table, correlation [B] mean off-diagonal,
      ok [B] (False -> drop patch).
    """
    H, hok, pt = warp_geometry(scene, cfg, center, normal, ref_cam, lod)
    vals = sampler(scene.pyramids, H, pt, lod, cam_mask, cfg.patch_radius)
    vok = vals > INVALID / 2
    ok = torch.all(torch.all(vok, dim=-1) | ~cam_mask, dim=-1)
    ok &= torch.all(hok | ~cam_mask, dim=-1)
    return ncc_from_vectors(torch.where(vok, vals, 0.0), cam_mask, ok)


def ncc_from_vectors(vecs, cam_mask, ok):
    """L2-normalize warped window vectors and build the pairwise NCC table
    + mean off-diagonal correlation (patch.cpp:249-266).

    vecs: [B, C, W2] raw warped intensities; ok: [B] validity.
    Returns (unit vecs, corr [B, C, C], correlation [B], ok).
    """
    C = vecs.shape[1]
    norm = torch.sqrt((vecs * vecs).sum(-1, keepdim=True))
    vecs = vecs / torch.where(norm > 0, norm, 1.0)

    corr = vecs @ vecs.transpose(1, 2)
    eye = torch.eye(C, dtype=torch.bool, device=vecs.device)
    pair_m = cam_mask[:, :, None] & cam_mask[:, None, :] & ~eye
    corr = corr * pair_m.to(corr.dtype)
    n = cam_mask.sum(-1).to(corr.dtype)
    denom = n * n - n
    correlation = corr.sum((1, 2)) / torch.where(denom > 0, denom, 1.0)
    correlation = torch.where(ok, correlation, 0.0)
    return vecs, corr, correlation, ok
