"""Reference-compatible binary ``.mvs`` checkpoint files.

Layout (TMVS/io/filewriter.cpp:71-102 / fileloader.cpp:403-472):
  "MVS_V3\\n"
  raw MvsConfig struct (160 bytes, MSVC layout — see config.py)
  "CAMERAS <n>\\n"
  per camera: int32 name length, name bytes, f64x3 center, f64x2 focal,
              f64x2 principal, f64x4 quaternion (wxyz), f64 radial distortion
  "PATCHES <n>\\n"
  per patch: f64x3 center, f64x2 spherical normal, int32 camNum,
             int32 x camNum camera indices, f64 fitness, f64 correlation

``MVS_V2`` (no config blob) is accepted on read (fileloader.cpp:432-435).
This format IS the reference's checkpoint/resume mechanism — staged dumps
and the expansion autosave both use it (SURVEY.md §5.4).

The port's copy of ``pais_mvs_tpu/io/mvsbin.py``: the same bytes, with the
config blob packed by the port's ``config.pack_config_binary``.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional

import numpy as np

from pais_mvs_tpu_torch.config import (MvsConfig, MVS_CONFIG_STRUCT_SIZE,
                                 pack_config_binary, unpack_config_binary)
from pais_mvs_tpu_torch.models.camera import CameraParams


class MvsPatchData(NamedTuple):
    centers: np.ndarray        # [M, 3]
    normal_sph: np.ndarray     # [M, 2]
    cam_masks: np.ndarray      # [M, C] bool
    fitness: np.ndarray        # [M]
    correlation: np.ndarray    # [M]


class MvsFile(NamedTuple):
    config: Optional[MvsConfig]
    cameras: List[CameraParams]
    patches: MvsPatchData


def write_mvs(path: str, cfg: MvsConfig, cameras: List[CameraParams],
              patches: MvsPatchData) -> None:
    with open(path, "wb") as f:
        f.write(b"MVS_V3\n")
        f.write(pack_config_binary(cfg))
        f.write(f"CAMERAS {len(cameras)}\n".encode())
        for c in cameras:
            name = c.file_name.encode()
            f.write(struct.pack("<i", len(name)))
            f.write(name)
            f.write(struct.pack("<3d", *np.asarray(c.center, dtype=np.float64)))
            f.write(struct.pack("<2d", *np.asarray(c.focal, dtype=np.float64)))
            f.write(struct.pack("<2d", *np.asarray(c.principal,
                                                   dtype=np.float64)))
            f.write(struct.pack("<4d", *np.asarray(c.quaternion,
                                                   dtype=np.float64)))
            f.write(struct.pack("<d", float(c.radial_distortion)))
        M = len(patches.centers)
        f.write(f"PATCHES {M}\n".encode())
        # vectorized record assembly — this is the autosave hot path
        # (every ~500 new patches): per-record layout is
        # <3d center><2d sph><i camNum><camNum x i camIdx><d fit><d corr>
        if M:
            k = patches.cam_masks.astype(bool).sum(axis=1).astype(np.int64)
            rec_len = 24 + 16 + 4 + 4 * k + 8 + 8
            off = np.concatenate([[0], np.cumsum(rec_len)])
            out = np.zeros(int(off[-1]), dtype=np.uint8)
            fixed = np.concatenate(
                [patches.centers.astype("<f8"),
                 patches.normal_sph.astype("<f8")], axis=1)     # [M, 5]
            out[off[:-1, None] + np.arange(40)] = \
                fixed.view(np.uint8).reshape(M, 40)
            out[off[:-1, None] + 40 + np.arange(4)] = \
                k.astype("<i4").view(np.uint8).reshape(M, 4)
            mi, ci = np.nonzero(patches.cam_masks)
            # rank of each camIdx within its patch row (mi is row-sorted)
            rank = np.arange(len(mi)) - np.repeat(
                np.concatenate([[0], np.cumsum(k)[:-1]]), k)
            pos = off[mi] + 44 + 4 * rank
            out[pos[:, None] + np.arange(4)] = \
                ci.astype("<i4").view(np.uint8).reshape(-1, 4)
            tail = np.stack([patches.fitness.astype("<f8"),
                             patches.correlation.astype("<f8")],
                            axis=1)                              # [M, 2]
            out[(off[:-1] + 44 + 4 * k)[:, None] + np.arange(16)] = \
                tail.view(np.uint8).reshape(M, 16)
            f.write(out.tobytes())


def _read_line(f) -> str:
    out = b""
    while True:
        ch = f.read(1)
        if not ch or ch == b"\n":
            break
        out += ch
    return out.decode(errors="replace")


def read_mvs(path: str) -> MvsFile:
    with open(path, "rb") as f:
        header = _read_line(f).split()
        if not header or header[0] not in ("MVS_V2", "MVS_V3"):
            raise ValueError(f"not an MVS file: {path}")
        cfg = None
        if header[0] == "MVS_V3":
            cfg = unpack_config_binary(f.read(MVS_CONFIG_STRUCT_SIZE))
        tok = _read_line(f).split()
        if len(tok) != 2 or tok[0] != "CAMERAS":
            raise ValueError(f"{path}: corrupt MVS file (expected "
                             f"'CAMERAS n', got {tok!r})")
        n_cams = int(tok[1])
        if not 0 <= n_cams < 100_000:
            raise ValueError(f"{path}: implausible camera count {n_cams}")
        cameras = []
        for _ in range(n_cams):
            (ln,) = struct.unpack("<i", f.read(4))
            name = f.read(ln).decode(errors="replace")
            center = np.array(struct.unpack("<3d", f.read(24)))
            focal = np.array(struct.unpack("<2d", f.read(16)))
            principal = np.array(struct.unpack("<2d", f.read(16)))
            quaternion = np.array(struct.unpack("<4d", f.read(32)))
            (rd,) = struct.unpack("<d", f.read(8))
            cameras.append(CameraParams(
                file_name=name, focal=focal, principal=principal,
                quaternion=quaternion, center=center, radial_distortion=rd))
        tok = _read_line(f).split()
        if len(tok) != 2 or tok[0] != "PATCHES":
            raise ValueError(f"{path}: corrupt MVS file (expected "
                             f"'PATCHES n', got {tok!r})")
        M = int(tok[1])
        if M < 0:
            raise ValueError(f"{path}: negative patch count {M}")
        centers = np.zeros((M, 3))
        sph = np.zeros((M, 2))
        masks = np.zeros((M, n_cams), dtype=bool)
        fit = np.zeros(M)
        corr = np.zeros(M)
        for m in range(M):
            centers[m] = struct.unpack("<3d", f.read(24))
            sph[m] = struct.unpack("<2d", f.read(16))
            (k,) = struct.unpack("<i", f.read(4))
            if not 0 <= k <= n_cams:
                # a truncated/corrupt autosave must fail loudly, not drive
                # a multi-GB read loop off a garbage camNum
                raise ValueError(f"{path}: corrupt patch record {m} "
                                 f"(camNum {k} of {n_cams} cameras)")
            for _ in range(k):
                (ci,) = struct.unpack("<i", f.read(4))
                if 0 <= ci < n_cams:
                    masks[m, ci] = True
            (fit[m],) = struct.unpack("<d", f.read(8))
            (corr[m],) = struct.unpack("<d", f.read(8))
    return MvsFile(cfg, cameras,
                   MvsPatchData(centers, sph, masks, fit, corr))
