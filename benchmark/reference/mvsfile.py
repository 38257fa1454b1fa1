"""Reader of the ``.mvs`` cloud the program writes (the upstream format,
TMVS/io/filewriter.cpp:71-102): "MVS_V3\\n", a 160-byte config blob,
"CAMERAS <n>\\n" and per camera int32 name length, name, f64 x 3 centre,
f64 x 2 focal, f64 x 2 principal, f64 x 4 quaternion, f64 radial; then
"PATCHES <n>\\n" and per patch f64 x 3 centre, f64 x 2 spherical normal
(theta, phi), int32 camera count, int32 camera indices, f64 fitness, f64
correlation. Written from the format's description; nothing of the
program is imported.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

CONFIG_BLOB = 160


class Cloud(NamedTuple):
    centers: np.ndarray        # [M, 3]
    normal_sph: np.ndarray     # [M, 2]
    cam_masks: np.ndarray      # [M, C] bool
    fitness: np.ndarray        # [M]
    correlation: np.ndarray    # [M]


def _line(buf: bytes, pos: int):
    end = buf.index(b"\n", pos)
    return buf[pos:end].decode(), end + 1


def _cameras(buf: bytes):
    """(camera count, offset of the PATCHES line)."""
    head, pos = _line(buf, 0)
    if head == "MVS_V3":
        pos += CONFIG_BLOB
    elif head != "MVS_V2":
        raise ValueError(f"not an .mvs file ({head!r})")
    line, pos = _line(buf, pos)
    C = int(line.split()[1])
    for _ in range(C):
        (n,) = struct.unpack_from("<i", buf, pos)
        pos += 4 + n + 8 * (3 + 2 + 2 + 4 + 1)
    return C, pos


def count_patches(buf: bytes) -> int:
    return int(_line(buf, _cameras(buf)[1])[0].split()[1])


def parse_cloud(buf: bytes) -> Cloud:
    C, pos = _cameras(buf)
    line, pos = _line(buf, pos)
    M = int(line.split()[1])
    centers = np.zeros((M, 3))
    sph = np.zeros((M, 2))
    masks = np.zeros((M, C), dtype=bool)
    fit = np.zeros(M)
    corr = np.zeros(M)
    for m in range(M):
        vals = struct.unpack_from("<5di", buf, pos)
        pos += 44
        centers[m], sph[m] = vals[:3], vals[3:5]
        k = vals[5]
        idx = np.frombuffer(buf, dtype="<i4", count=k, offset=pos)
        pos += 4 * k
        masks[m, idx] = True
        fit[m], corr[m] = struct.unpack_from("<2d", buf, pos)
        pos += 16
    return Cloud(centers, sph, masks, fit, corr)


def read_cloud(path: str) -> Cloud:
    with open(path, "rb") as f:
        return parse_cloud(f.read())
