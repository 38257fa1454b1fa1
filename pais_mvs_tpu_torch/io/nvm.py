"""VisualSFM NVM / NVM2 ingestion.

Format per the reference loader (TMVS/io/fileloader.cpp:15-110, 251-401):
``NVM_V3`` header; camera count; one line per camera
(name, focal, quaternion wxyz, center xyz, radial distortion, 0);
point count; one line per point (xyz, rgb, #measurements,
then per measurement: cam index, feature index, x, y). Measurement
coordinates are center-origin — the loader adds width/2, height/2
(fileloader.cpp:156-160). NVM2 cameras carry fx fy px py instead of a
single focal (fileloader.cpp:62-109).

The port's copy of ``pais_mvs_tpu/io/nvm.py`` (host numpy).
"""

from __future__ import annotations

from typing import List

import numpy as np

from pais_mvs_tpu_torch.models.camera import CameraParams


class NvmData:
    def __init__(self, cameras, centers, colors, cam_masks, img_points):
        self.cameras: List[CameraParams] = cameras
        self.centers: np.ndarray = centers          # [M, 3]
        self.colors: np.ndarray = colors            # [M, 3] RGB
        self.cam_masks: np.ndarray = cam_masks      # [M, C] bool
        self.img_points: np.ndarray = img_points    # [M, C, 2] (centered coords)


def _tokens(line: str):
    return line.split()


def load_nvm(path: str, nvm2: bool = False) -> NvmData:
    with open(path, "r") as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    # find header
    while i < len(lines) and not lines[i].split():
        i += 1
    header = lines[i].split()[0]
    if header != "NVM_V3":
        raise ValueError(f"not an NVM_V3 file: {path}")
    i += 1
    while not lines[i].split():
        i += 1
    num_cams = int(lines[i].split()[0])
    i += 1
    cams = []
    for _ in range(num_cams):
        t = _tokens(lines[i]); i += 1
        name = t[0]
        if nvm2:
            focal = np.array([float(t[1]), float(t[2])])
            principal = np.array([float(t[3]), float(t[4])])
            q = np.array([float(x) for x in t[5:9]])
            c = np.array([float(x) for x in t[9:12]])
            rd = 0.0
        else:
            focal = np.array([float(t[1]), float(t[1])])
            principal = np.array([-1.0, -1.0])
            q = np.array([float(x) for x in t[2:6]])
            c = np.array([float(x) for x in t[6:9]])
            rd = float(t[9])
        cams.append(CameraParams(
            file_name=name, focal=focal, principal=principal,
            quaternion=q, center=c, radial_distortion=rd))

    # points (optional)
    centers, colors, masks, ipts = [], [], [], []
    while i < len(lines) and not lines[i].split():
        i += 1
    if i < len(lines):
        num_pts = int(lines[i].split()[0])
        i += 1
        for _ in range(num_pts):
            t = _tokens(lines[i]); i += 1
            xyz = [float(t[0]), float(t[1]), float(t[2])]
            rgb = [int(t[3]), int(t[4]), int(t[5])]
            n = int(t[6])
            mask = np.zeros(num_cams, dtype=bool)
            pts = np.zeros((num_cams, 2))
            for m in range(n):
                base = 7 + 4 * m
                ci = int(t[base])
                # t[base+1] is the feature index (unused)
                mask[ci] = True
                pts[ci] = (float(t[base + 2]), float(t[base + 3]))
            centers.append(xyz)
            colors.append(rgb)
            masks.append(mask)
            ipts.append(pts)
    M = len(centers)
    return NvmData(
        cams,
        np.asarray(centers, dtype=np.float64).reshape(M, 3),
        np.asarray(colors, dtype=np.float64).reshape(M, 3),
        np.asarray(masks, dtype=bool).reshape(M, num_cams),
        np.asarray(ipts, dtype=np.float64).reshape(M, num_cams, 2))


def decenter_image_points(nvm: NvmData, widths, heights) -> np.ndarray:
    """NVM measurements are center-origin; convert to pixel coordinates by
    adding (w/2, h/2) of each camera's image (fileloader.cpp:156-160)."""
    out = nvm.img_points.copy()
    for c in range(out.shape[1]):
        out[:, c, 0] += widths[c] // 2
        out[:, c, 1] += heights[c] // 2
    return out


def save_nvm(path: str, cameras: List[CameraParams],
             centers: np.ndarray | None = None,
             colors: np.ndarray | None = None,
             cam_masks: np.ndarray | None = None,
             img_points: np.ndarray | None = None,
             nvm2: bool = False) -> None:
    """Write an NVM_V3 file (img_points given in CENTERED coordinates).
    ``nvm2`` writes the extended camera lines (fx fy px py — anisotropic
    focal + explicit principal point, fileloader.cpp:62-109)."""
    with open(path, "w") as f:
        f.write("NVM_V3 \n\n")
        f.write(f"{len(cameras)}\n")
        for p in cameras:
            q = p.quaternion
            c = p.center
            if nvm2:
                f.write(f"{p.file_name}\t{p.focal[0]:.9g} {p.focal[1]:.9g} "
                        f"{p.principal[0]:.9g} {p.principal[1]:.9g} "
                        f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} "
                        f"{c[0]:.9g} {c[1]:.9g} {c[2]:.9g} 0\n")
            else:
                f.write(f"{p.file_name}\t{p.focal[0]:.9g} "
                        f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} "
                        f"{c[0]:.9g} {c[1]:.9g} {c[2]:.9g} "
                        f"{p.radial_distortion:.9g} 0\n")
        f.write("\n")
        if centers is None or len(centers) == 0:
            f.write("0\n")
            return
        if cam_masks is None or img_points is None:
            raise ValueError("save_nvm: cam_masks and img_points are "
                             "required when centers is non-empty")
        f.write(f"{len(centers)}\n")
        for m in range(len(centers)):
            x, y, z = centers[m]
            r, g, b = (colors[m] if colors is not None else (128, 128, 128))
            views = np.nonzero(cam_masks[m])[0]
            f.write(f"{x:.9g} {y:.9g} {z:.9g} {int(r)} {int(g)} {int(b)} "
                    f"{len(views)}")
            for ci in views:
                u, v = img_points[m, ci]
                f.write(f" {ci} 0 {u:.6g} {v:.6g}")
            f.write("\n")
