"""N-view track union + triangulation into seed patches.

The PyTorch counterpart of ``pais_mvs_tpu/features/seeding.py``. Reference:
FeatureManager::setSeedPatches (TMVS/mvs/featuremanager.cpp:5-116) —
pairwise matches merged into n-view tracks (:118-156 setNVMatch), tracks
with >= minCamNum views triangulated into seed patches (:84-98).

Detection, description and matching run on the device the caller names;
the union-find, the triangulation and the colour pick run on the host in
numpy float64 (tiny, irregular), as in the JAX package.

Given a job's ``Trace`` (``pais_mvs_tpu_torch.trace``), the pipeline
records the spans features/detect (per camera: the grey conversion,
``detect_and_describe`` and the keypoints' fetch), features/match (the
fundamental matrices and ``match_all_pairs``) and features/tracks (the
union, the triangulation and the colours), and the counters keypoints
(the true mask slots of every camera), pairs_matched, pairs_kept (the
pairs at or above a quarter of the best pair's matches), pair_matches
(the kept pairs' matches), tracks and feature_seeds.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pais_mvs_tpu_torch import resolve_device
from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.features import describe as dsc
from pais_mvs_tpu_torch.features import detect as det
from pais_mvs_tpu_torch.features import matching as mat
from pais_mvs_tpu_torch.models.camera import CameraParams, _np_quat_to_rotation
from pais_mvs_tpu_torch.ops import pyramid as pyr
from pais_mvs_tpu_torch.trace import Trace


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, a: int) -> int:
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def merge_tracks(pair_matches: Dict[Tuple[int, int],
                                    Tuple[np.ndarray, np.ndarray]],
                 num_cams: int, k_per_cam: int,
                 min_cam_num: int) -> List[Dict[int, int]]:
    """Union pairwise matches into n-view tracks.

    Returns a list of {cam: keypoint_idx} maps, one per consistent track
    with >= min_cam_num views. Tracks containing two DIFFERENT keypoints of
    the same camera are dropped (the reference's cross-match consistency,
    featuremanager.cpp:197-247).
    """
    uf = _UnionFind(num_cams * k_per_cam)
    for (i, j), (i1, i2) in pair_matches.items():
        for a, b in zip(i1.tolist(), i2.tolist()):
            uf.union(i * k_per_cam + a, j * k_per_cam + b)

    groups: Dict[int, Dict[int, set]] = {}
    seen = set()
    for (i, j), (i1, i2) in pair_matches.items():
        for a, b in zip(i1.tolist(), i2.tolist()):
            for cam, kp in ((i, a), (j, b)):
                node = cam * k_per_cam + kp
                if node in seen:
                    continue
                seen.add(node)
                root = uf.find(node)
                groups.setdefault(root, {}).setdefault(cam, set()).add(kp)

    tracks = []
    for views in groups.values():
        if len(views) < min_cam_num:
            continue
        if any(len(kps) > 1 for kps in views.values()):
            continue   # inconsistent: two keypoints of one camera merged
        tracks.append({cam: next(iter(kps)) for cam, kps in views.items()})
    return tracks


def detect_and_describe(img: np.ndarray, device, k_per_octave: int = 192,
                        num_octaves: int = 4):
    """Keypoints and their [K, 128] descriptors of one uint8 image, on
    ``device``: the per-camera device stage of the seeding."""
    gray = pyr.rgb_to_gray(pyr.host_tensor(img)).float()
    kp, gaussians = det.detect_keypoints(
        gray.to(device), num_octaves=num_octaves,
        k_per_octave=k_per_octave)
    # detect_keypoints appends one full, fixed-size masked block of
    # k_per_octave rows per octave, in octave order: describe each block
    # against its own blurred stack
    parts = []
    for o, g in enumerate(gaussians):
        sel = slice(o * k_per_octave, (o + 1) * k_per_octave)
        parts.append(dsc.describe_octave(g, kp.xy_oct[sel],
                                         kp.sigma_oct[sel], kp.level[sel]))
    return kp, torch.cat(parts)


def generate_seed_patches(params: Sequence[CameraParams],
                          images: Sequence[np.ndarray],
                          cfg: MvsConfig,
                          max_epipolar_dist: float = 3.0,
                          k_per_octave: int = 192,
                          num_octaves: int = 4,
                          device="cuda",
                          trace: Optional[Trace] = None):
    """Full seeding pipeline: detect -> describe -> match -> tracks ->
    triangulate. Returns (centers [M,3], cam_masks [M,C], img_points
    [M,C,2], colors [M,3]) numpy arrays ready for Reconstructor.load_seeds.
    ``trace`` gets the pipeline's spans and counters (module note).
    """
    dev = resolve_device(device)
    C = len(params)
    span = ((lambda name: contextlib.nullcontext()) if trace is None
            else trace.span)
    count = (lambda name, n: None) if trace is None else trace.count
    descs, xys, masks, kps = [], [], [], []
    Rs, Ts, Ks, centers_np, focals, pps = [], [], [], [], [], []
    for p, img in zip(params, images):
        h, w = img.shape[:2]
        with span("features/detect"):
            kp, desc = detect_and_describe(img, dev, k_per_octave,
                                           num_octaves)
            # the keypoints and their mask in the one fetch
            xym = torch.cat([kp.xy, kp.mask[:, None].to(kp.xy.dtype)],
                            1).cpu().numpy()
        descs.append(desc)
        xys.append(kp.xy)
        masks.append(kp.mask)
        kps.append(xym[:, :2])
        count("keypoints", int(np.count_nonzero(xym[:, 2])))

        R = _np_quat_to_rotation(np.asarray(p.quaternion, dtype=np.float64))
        c = np.asarray(p.center, dtype=np.float64)
        f = np.asarray(p.focal, dtype=np.float64)
        pp = np.asarray(p.principal, dtype=np.float64)
        if pp[0] < 0 and pp[1] < 0:
            pp = np.array([w >> 1, h >> 1], dtype=np.float64)
        K = np.array([[f[0], 0, pp[0]], [0, f[1], pp[1]], [0, 0, 1.0]])
        Rs.append(R); Ts.append(-R @ c); Ks.append(K)
        centers_np.append(c); focals.append(f); pps.append(pp)

    with span("features/match"):
        Fs = [[None] * C for _ in range(C)]
        for i in range(C):
            for j in range(C):
                if i != j:
                    Fs[i][j] = mat.fundamental_from_rig(
                        Rs[i], Ts[i], Ks[i], Rs[j], Ts[j], Ks[j])
        pairs = mat.match_all_pairs(descs, xys, masks, Fs,
                                    max_epipolar_dist=max_epipolar_dist)
    count("pairs_matched", C * (C - 1) // 2)
    count("pairs_kept", len(pairs))
    count("pair_matches", sum(len(i1) for i1, _ in pairs.values()))
    with span("features/tracks"):
        out = _tracks_to_seeds(pairs, xys, kps, images, C, cfg, Rs,
                               centers_np, focals, pps, count)
    count("feature_seeds", len(out[0]))
    return out


def _tracks_to_seeds(pairs, xys, kps, images, C, cfg, Rs, centers_np,
                     focals, pps, count):
    """The kept pairs' matches merged into tracks, triangulated and
    coloured: ``generate_seed_patches``' result."""
    # cameras of different sizes yield different octave/keypoint counts —
    # size the union-find by the LARGEST so node ids never collide
    k_per_cam = max(int(x.shape[0]) for x in xys)
    tracks = merge_tracks(pairs, C, k_per_cam, cfg.min_cam_num)
    count("tracks", len(tracks))
    if not tracks:
        z = np.zeros
        return (z((0, 3)), z((0, C), dtype=bool), z((0, C, 2)), z((0, 3)))

    M = len(tracks)
    cam_masks = np.zeros((M, C), dtype=bool)
    img_points = np.zeros((M, C, 2))
    for t, views in enumerate(tracks):
        for cam, kpi in views.items():
            cam_masks[t, cam] = True
            img_points[t, cam] = kps[cam][kpi]

    # triangulate each track from pixel rays (reference uses
    # Patch::reCentering after seeding, featuremanager.cpp:84-98) —
    # vectorized normal equations sum(I - n n^T) x = sum((I - n n^T) o)
    cam_centers = np.stack(centers_np)                      # [C, 3]
    dirs = np.zeros((M, C, 3))
    for cam in range(C):
        uv = img_points[:, cam]
        d = np.stack([(uv[:, 0] - pps[cam][0]) / focals[cam][0],
                      (uv[:, 1] - pps[cam][1]) / focals[cam][1],
                      np.ones(M)], axis=-1) @ Rs[cam]       # R^T row-applied
        dirs[:, cam] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    m = cam_masks[..., None].astype(np.float64)
    P = (np.eye(3)[None, None] - dirs[..., :, None] * dirs[..., None, :]) \
        * m[..., None]
    A = P.sum(axis=1)                                       # [M, 3, 3]
    b = np.einsum("mcij,cj->mi", P, cam_centers)
    centers = np.einsum("mij,mj->mi", np.linalg.pinv(A), b)
    good = np.all(np.isfinite(centers), axis=-1)

    colors = np.zeros((M, 3))
    for t in range(M):
        cam = int(np.nonzero(cam_masks[t])[0][0])
        u, v = img_points[t, cam]
        h, w = images[cam].shape[:2]
        ui = int(np.clip(round(u), 0, w - 1))
        vi = int(np.clip(round(v), 0, h - 1))
        px = images[cam][vi, ui]
        colors[t] = px if px.ndim else np.repeat(px, 3)

    return (centers[good], cam_masks[good], img_points[good], colors[good])
