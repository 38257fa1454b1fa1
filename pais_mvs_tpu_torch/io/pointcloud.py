"""Point-cloud exports: ASCII PLY and binary PSR.

Ref: FileWriter::writePLY (TMVS/io/filewriter.cpp:104-139) — ascii PLY with
xyz + normal + uchar diffuse rgb; FileWriter::wirtePSR [sic]
(filewriter.cpp:141-171) — raw float32 xyz+normal records for Poisson
surface reconstruction.
"""

from __future__ import annotations

import struct

import numpy as np


def write_ply(path: str, centers: np.ndarray, normals: np.ndarray,
              colors: np.ndarray) -> None:
    """colors: [N, 3] RGB 0..255."""
    N = len(centers)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {N}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write("property uchar diffuse_red\nproperty uchar diffuse_green\n"
                "property uchar diffuse_blue\nend_header\n")
        # vectorized row formatting: this runs on the autosave/snapshot
        # hot path (every ~500 patches), where a per-row f.write loop is
        # seconds of host time at 100k+ patches
        if N:
            body = np.concatenate(
                [np.asarray(centers, np.float64),
                 np.asarray(normals, np.float64),
                 np.asarray(colors, np.float64)], axis=-1)
            np.savetxt(f, body,
                       fmt="%.9g %.9g %.9g %.9g %.9g %.9g %d %d %d")


def read_ply(path: str):
    """Minimal reader for the PLY files this package writes.

    Returns (centers [N,3], normals [N,3], colors [N,3])."""
    with open(path, "r") as f:
        line = f.readline().strip()
        if line != "ply":
            raise ValueError(f"{path}: not a PLY file")
        n = 0
        while True:
            raw = f.readline()
            if raw == "":                       # EOF before end_header
                raise ValueError(f"{path}: truncated PLY header")
            line = raw.strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        data = np.loadtxt(f, max_rows=n).reshape(n, 9)
    return data[:, :3], data[:, 3:6], data[:, 6:9]


def write_psr(path: str, centers: np.ndarray, normals: np.ndarray) -> None:
    arr = np.concatenate([centers, normals], axis=-1).astype("<f4")
    with open(path, "wb") as f:
        f.write(arr.tobytes())


def read_psr(path: str):
    raw = np.fromfile(path, dtype="<f4").reshape(-1, 6)
    return raw[:, :3], raw[:, 3:]
