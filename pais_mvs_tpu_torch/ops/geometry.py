"""Core projective geometry as shape-polymorphic torch functions.

The PyTorch counterpart of ``pais_mvs_tpu/ops/geometry.py``: the same
formulas (reference TMVS primitives cited per function), batched by
broadcasting instead of ``vmap``. Small matrix-vector products are written
as elementwise sums, so no BLAS call (and no TF32 path) touches them.

Conventions
-----------
* World-to-camera: ``x_cam = R @ X + T`` with ``T = -R @ C`` (C = camera
  center), pixel ``u = f * x/z + pp`` (reference TMVS/mvs/camera.cpp:108-160).
* Patch normals are stored in spherical form (theta, phi) with
  ``n = (sin t cos p, sin t sin p, cos t)`` (TMVS/mvs/utility.h:17-29).
"""

from __future__ import annotations

import torch

# Large sentinel standing in for the reference's DBL_MAX rejections; kept
# finite so downstream min/exp arithmetic stays NaN-free in f32.
BIG = 1e30


def _mv(M, v):
    """M @ v over leading dims: [..., 3, 3] x [..., 3] -> [..., 3]."""
    return (M * v[..., None, :]).sum(-1)


def _mtv(M, v):
    """M^T @ v over leading dims."""
    return (M * v[..., :, None]).sum(-2)


def _scale(lod_scale):
    return lod_scale[..., None] if torch.is_tensor(lod_scale) else lod_scale


# ---------------------------------------------------------------------------
# spherical normals
# ---------------------------------------------------------------------------

def spherical_to_normal(sph):
    """(theta, phi) -> unit normal. Ref: TMVS/mvs/utility.h:25-29."""
    t, p = sph[..., 0], sph[..., 1]
    st = torch.sin(t)
    return torch.stack([st * torch.cos(p), st * torch.sin(p), torch.cos(t)],
                       dim=-1)


def normal_to_spherical(n):
    """unit normal -> (theta in [0,pi], phi in [-pi,pi]). Ref: utility.h:17-22."""
    theta = torch.arccos(torch.clamp(n[..., 2], -1.0, 1.0))
    phi = torch.arctan2(n[..., 1], n[..., 0])
    return torch.stack([theta, phi], dim=-1)


# ---------------------------------------------------------------------------
# rotations / projection
# ---------------------------------------------------------------------------

def quat_to_rotation(q):
    """Quaternion (w, x, y, z) -> 3x3 rotation, normalizing first.

    Same element formulas as the reference (TMVS/mvs/camera.cpp:6-34),
    including its fallback to identity for an all-zero quaternion.
    """
    qq = torch.linalg.norm(q, dim=-1, keepdim=True)
    unit = torch.cat([torch.ones_like(q[..., :1]),
                      torch.zeros_like(q[..., 1:])], dim=-1)
    qn = torch.where(qq > 0, q / torch.where(qq > 0, qq, 1.0), unit)
    w, x, y, z = qn[..., 0], qn[..., 1], qn[..., 2], qn[..., 3]
    r = torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - z * w), 2 * (y * w + z * x),
        2 * (x * y + w * z), y * y + w * w - z * z - x * x, 2 * (z * y - x * w),
        2 * (x * z - y * w), 2 * (y * z + w * x), z * z + w * w - y * y - x * x,
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def project(X, R, T, focal, principal, lod_scale=1.0, distortion=None):
    """Project world point(s) to pixel coords at a pyramid level.

    Ref: TMVS/mvs/camera.cpp:138-160 — pinhole + optional single radial
    distortion coefficient applied to *normalized* coords, and the final
    pixel coordinate scaled by ``lodRatio**LOD``.

    Args:
      X: [..., 3] world points; R [..., 3, 3], T [..., 3], focal [..., 2],
        principal [..., 2] broadcast against X (one camera, or one per row).
      lod_scale: scalar or tensor broadcastable to X[..., 0].

    Returns:
      (xy [..., 2], depth_z [...]) — z in camera frame (callers gate on z).
    """
    xc = _mv(R, X) + T
    z = xc[..., 2]
    safe_z = torch.where(z == 0, 1.0, z)
    xn = xc[..., 0] / safe_z
    yn = xc[..., 1] / safe_z
    if distortion is not None:
        rr = distortion * (xn * xn + yn * yn)
        scale = 1.0 + rr
        u = scale * focal[..., 0] * xn + principal[..., 0]
        v = scale * focal[..., 1] * yn + principal[..., 1]
    else:
        u = focal[..., 0] * xn + principal[..., 0]
        v = focal[..., 1] * yn + principal[..., 1]
    xy = torch.stack([u, v], dim=-1) * _scale(lod_scale)
    return xy, z


def pixel_to_world_dir(xy, R, C, focal, principal):
    """World-space unit ray direction through pixel ``xy`` (level-0 coords).

    Matches the reference's pixel back-projection (TMVS/mvs/patch.cpp:80-90,
    mvs.cpp:819-831): p3d = R^T((px-pp)/f, 1) + C, dir = normalize(p3d - C).
    """
    d = torch.stack([
        (xy[..., 0] - principal[..., 0]) / focal[..., 0],
        (xy[..., 1] - principal[..., 1]) / focal[..., 1],
        torch.ones_like(xy[..., 0]),
    ], dim=-1)
    w = _mtv(R, d)
    return w / torch.linalg.norm(w, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

def triangulate_rays(origins, dirs, mask):
    """Least-squares intersection point of masked 3D rays.

    Accumulates the normal equations sum(I - n n^T) x = sum((I - n n^T) o)
    over valid rays, solved with a pseudo-inverse — the reference's SVD
    triangulation (TMVS/mvs/patch.cpp:67-112).

    Args: origins [..., K, 3], dirs [..., K, 3], mask [..., K] bool.
    Returns: [..., 3] point.
    """
    m = mask[..., None].to(origins.dtype)
    eye = torch.eye(3, dtype=origins.dtype, device=origins.device)
    nnT = dirs[..., :, None] * dirs[..., None, :]
    P = (eye - nnT) * m[..., None]            # [..., K, 3, 3]
    A = P.sum(-3)
    b = _mv(P, origins.expand_as(dirs)).sum(-2)
    # pinv mirrors the reference's DECOMP_SVD solve and tolerates rank loss.
    return _mv(torch.linalg.pinv(A), b)


def estimated_normal(center, cam_centers, mask):
    """Initial patch normal = normalized sum of unit vectors to visible
    camera centers (TMVS/mvs/patch.cpp:390-413)."""
    d = cam_centers - center[..., None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    n = (d * mask[..., None]).sum(-2)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def ray_plane_intersect(origin, direction, plane_point, plane_normal):
    """Point where a ray meets the plane through ``plane_point`` with
    ``plane_normal`` (TMVS/mvs/mvs.cpp:809-836)."""
    denom = (plane_normal * direction).sum(-1)
    u = (plane_normal * (plane_point - origin)).sum(-1) / torch.where(
        denom == 0, 1.0, denom)
    return origin + u[..., None] * direction


# ---------------------------------------------------------------------------
# plane-induced homographies
# ---------------------------------------------------------------------------

def plane_homography(center, normal, R_ref, T_ref, f_ref, pp_ref,
                     R_tgt, T_tgt, f_tgt, pp_tgt, lod_scale):
    """Plane-induced homography mapping reference-image pixels (at a given
    LOD scale) into a target view: H = L K_t (R_rel + t_rel n_r^T / d_r)
    (L K_ref)^-1, reparameterized in the reference camera frame so it only
    degenerates when the plane passes through the reference camera center
    (see ``pais_mvs_tpu/ops/geometry.py::plane_homography`` and
    TMVS/mvs/patch.cpp:290-330).

    All args broadcast over leading dims; returns (H [..., 3, 3], ok [...]).
    """
    n_r = _mv(R_ref, normal)
    X_r = _mv(R_ref, center) + T_ref
    d_r = (n_r * X_r).sum(-1)                          # cam-to-plane distance
    ok = torch.abs(d_r) > 1e-12

    # relative pose ref -> tgt: R_t @ R_r^T
    R_rel = (R_tgt[..., :, None, :] * R_ref[..., None, :, :]).sum(-1)
    t_rel = T_tgt - _mv(R_rel, T_ref)

    M = R_rel + (t_rel[..., :, None] * n_r[..., None, :]
                 ) / torch.where(ok, d_r, 1.0)[..., None, None]

    # LK_tgt @ M
    s = lod_scale
    fx_t = s * f_tgt[..., 0]
    fy_t = s * f_tgt[..., 1]
    cx_t = s * pp_tgt[..., 0]
    cy_t = s * pp_tgt[..., 1]
    row0 = fx_t[..., None] * M[..., 0, :] + cx_t[..., None] * M[..., 2, :]
    row1 = fy_t[..., None] * M[..., 1, :] + cy_t[..., None] * M[..., 2, :]
    row2 = M[..., 2, :]
    KM = torch.stack([row0, row1, row2], dim=-2)

    # ... @ (LK_ref)^-1 with the closed-form upper-triangular inverse
    inv_fx = 1.0 / (s * f_ref[..., 0])
    inv_fy = 1.0 / (s * f_ref[..., 1])
    ox = -pp_ref[..., 0] / f_ref[..., 0]
    oy = -pp_ref[..., 1] / f_ref[..., 1]
    col0 = KM[..., :, 0] * inv_fx[..., None]
    col1 = KM[..., :, 1] * inv_fy[..., None]
    col2 = (KM[..., :, 0] * ox[..., None] + KM[..., :, 1] * oy[..., None]
            + KM[..., :, 2])
    H = torch.stack([col0, col1, col2], dim=-1)
    return H, ok


def homography_apply(H, xy):
    """Apply projective H to 2D points. xy: [..., 2] -> ([..., 2], w)."""
    x, y = xy[..., 0], xy[..., 1]
    w = H[..., 2, 0] * x + H[..., 2, 1] * y + H[..., 2, 2]
    sw = torch.where(w == 0, 1.0, w)
    u = (H[..., 0, 0] * x + H[..., 0, 1] * y + H[..., 0, 2]) / sw
    v = (H[..., 1, 0] * x + H[..., 1, 1] * y + H[..., 1, 2]) / sw
    return torch.stack([u, v], dim=-1), w


def homography_region_ratio(H, pt):
    """Anisotropy of the warped patch window: min/max singular value of the
    2x2 Jacobian of H at ``pt`` (closed-form stand-in for the reference's
    8-point ellipse fit, TMVS/mvs/patch.cpp:269-288)."""
    x, y = pt[..., 0], pt[..., 1]
    w = H[..., 2, 0] * x + H[..., 2, 1] * y + H[..., 2, 2]
    u = H[..., 0, 0] * x + H[..., 0, 1] * y + H[..., 0, 2]
    v = H[..., 1, 0] * x + H[..., 1, 1] * y + H[..., 1, 2]
    sw = torch.where(w == 0, 1.0, w)
    iw = 1.0 / sw
    # d(u/w)/dx = (u_x * w - u * w_x) / w^2, etc.
    j00 = (H[..., 0, 0] - u * iw * H[..., 2, 0]) * iw
    j01 = (H[..., 0, 1] - u * iw * H[..., 2, 1]) * iw
    j10 = (H[..., 1, 0] - v * iw * H[..., 2, 0]) * iw
    j11 = (H[..., 1, 1] - v * iw * H[..., 2, 1]) * iw
    a = j00 * j00 + j01 * j01 + j10 * j10 + j11 * j11
    det = j00 * j11 - j01 * j10
    disc = torch.sqrt(torch.clamp(a * a - 4.0 * det * det, min=0.0))
    smax2 = 0.5 * (a + disc)
    smin2 = 0.5 * (a - disc)
    ratio = torch.sqrt(torch.clamp(smin2, min=0.0)
                       / torch.where(smax2 > 0, smax2, 1.0))
    return torch.where((smax2 > 0) & (w != 0), ratio, 0.0)
