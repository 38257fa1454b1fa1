"""ctypes binding for the native host runtime (``native/runtime.cpp``).

The port's counterpart of ``pais_mvs_tpu/native/__init__.py``. The C++
source here is a byte-identical copy of the JAX package's (a test holds the
two equal); the port reads and builds only its own copy.

The shared library is built at first use (``lib()``), never at import:
``g++ -O3 -std=c++17 -shared -fPIC`` into ``pais_mvs_tpu_torch/_build/``,
keyed by a hash of the source and flags, through a per-process temporary
file and an atomic rename, so concurrent processes never load a
half-written library. A failed build raises with the compiler's output:
the engine's pure-Python mirror runs only when a caller asks for it
(``Reconstructor(use_native=False)``), never in place of a broken build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from pais_mvs_tpu_torch.engine.cellgrid import GridCoordsMixin

SRC = Path(__file__).resolve().parent / "runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LIB = None


def _library_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtmvs_runtime_{tag[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        try:
            r = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native runtime: g++ could not run: {e}") \
                from e
        if r.returncode != 0:
            raise RuntimeError(f"native runtime: g++ failed on {SRC}:\n"
                               f"{r.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def lib():
    """The bound runtime library, built on first call; raises on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = _library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))

    c = ctypes
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.tg_create.restype = c.c_void_p
    lib.tg_create.argtypes = [c.c_int, i32p, i32p, c.c_int]
    lib.tg_destroy.restype = None
    lib.tg_destroy.argtypes = [c.c_void_p]
    lib.tg_grid_dims.restype = c.c_int
    lib.tg_grid_dims.argtypes = [c.c_void_p, c.c_int,
                                 c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.tg_insert_patch.restype = None
    lib.tg_insert_patch.argtypes = [c.c_void_p, c.c_int, u8p, dp]
    lib.tg_remove_patch.restype = None
    lib.tg_remove_patch.argtypes = [c.c_void_p, c.c_int, u8p, dp]
    lib.tg_cell_count.restype = c.c_int
    lib.tg_cell_count.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int]
    lib.tg_all_cells.restype = c.c_int
    lib.tg_all_cells.argtypes = [c.c_void_p, i32p, i32p, i32p, c.c_int]
    lib.tg_cell_ids.restype = c.c_int
    lib.tg_cell_ids.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int,
                                i32p, c.c_int]
    lib.tg_insert_time_filter.restype = c.c_int
    lib.tg_insert_time_filter.argtypes = [c.c_void_p, u8p, dp, c.c_int]
    lib.tg_candidates.restype = c.c_int
    lib.tg_candidates.argtypes = [
        c.c_void_p, i64p, c.c_int, dp, dp, dp, u8p, u8p, dp,
        c.c_double, c.c_double, c.c_int, i64p, i32p, i32p, i32p, c.c_int]
    lib.tg_neighbor_counts.restype = None
    lib.tg_neighbor_counts.argtypes = [dp, i64p, c.c_int, c.c_double, i64p]
    lib.tg_cell_filter.restype = c.c_int
    lib.tg_cell_filter.argtypes = [c.c_void_p, i32p, i32p, i32p, c.c_int,
                                   dp, u8p, dp, u8p, i64p, c.c_int]
    lib.tg_visibility_filter.restype = c.c_int
    lib.tg_visibility_filter.argtypes = [c.c_void_p, i64p, c.c_int, dp, dp,
                                         u8p, dp, u8p, c.c_int, i64p, c.c_int]
    lib.tg_neighbor_cell_filter.restype = c.c_int
    lib.tg_neighbor_cell_filter.argtypes = [
        c.c_void_p, i32p, i32p, i32p, c.c_int, dp, dp, u8p, dp, u8p,
        c.c_double, c.c_double, i64p, c.c_int]
    lib.tg_batch_insert.restype = c.c_int
    lib.tg_batch_insert.argtypes = [c.c_void_p, i64p, c.c_int, u8p, u8p, dp,
                                    i64p, i32p, i32p, i32p, dp, dp, dp, u8p,
                                    dp, dp, dp, c.c_double, c.c_double,
                                    c.c_int, c.c_int64, u8p]
    _LIB = lib
    return lib


class NativeCellGrids(GridCoordsMixin):
    """Drop-in counterpart of ``engine.cellgrid.CellGrids`` backed by C++.
    Coordinate math (cell_of / in_map / grid dims) is SHARED with the
    Python grid via GridCoordsMixin — the bit-parity contract."""

    def __init__(self, widths, heights, cell_size: int):
        self._lib = lib()
        self.cell_size = cell_size
        self._w = np.asarray(widths, dtype=np.int32)
        self._h = np.asarray(heights, dtype=np.int32)
        self._g = self._lib.tg_create(len(self._w), self._w, self._h,
                                      cell_size)
        self.width = self.grid_dims([int(w) for w in self._w], cell_size)
        self.height = self.grid_dims([int(h) for h in self._h], cell_size)

    def __del__(self):
        if getattr(self, "_g", None):
            self._lib.tg_destroy(self._g)
            self._g = None

    def cell(self, cam: int, cx: int, cy: int):
        n = self._lib.tg_cell_count(self._g, cam, cx, cy)
        if n == 0:
            return []
        out = np.empty(n, dtype=np.int32)
        n = self._lib.tg_cell_ids(self._g, cam, cx, cy, out, n)
        return out[:n].tolist()

    def cell_count(self, cam: int, cx: int, cy: int) -> int:
        return self._lib.tg_cell_count(self._g, cam, cx, cy)

    def all_keys(self):
        """Sorted (cam, cx, cy) keys of every non-empty cell."""
        n = self._lib.tg_all_cells(self._g, np.empty(0, np.int32),
                                   np.empty(0, np.int32),
                                   np.empty(0, np.int32), 0)
        if n == 0:
            return []
        oc = np.empty(n, np.int32)
        ox = np.empty(n, np.int32)
        oy = np.empty(n, np.int32)
        n = self._lib.tg_all_cells(self._g, oc, ox, oy, n)
        return sorted(zip(oc.tolist(), ox.tolist(), oy.tolist()))

    def insert_patch(self, pid: int, cam_mask, img_points) -> None:
        self._lib.tg_insert_patch(
            self._g, int(pid),
            np.ascontiguousarray(cam_mask, dtype=np.uint8),
            np.ascontiguousarray(img_points, dtype=np.float64))

    def remove_patch(self, pid: int, cam_mask, img_points) -> None:
        self._lib.tg_remove_patch(
            self._g, int(pid),
            np.ascontiguousarray(cam_mask, dtype=np.uint8),
            np.ascontiguousarray(img_points, dtype=np.float64))

    def insert_time_filter(self, cam_mask, img_points,
                           max_cell_patch_num: int) -> bool:
        return bool(self._lib.tg_insert_time_filter(
            self._g, np.ascontiguousarray(cam_mask, dtype=np.uint8),
            np.ascontiguousarray(img_points, dtype=np.float64),
            max_cell_patch_num))

    def candidates(self, parents, centers, normal_sph, correlation, alive,
                   cam_mask, img_pts, min_correlation: float,
                   neighbor_radius: float, max_cell_patch_num: int):
        """Whole-wavefront candidate generation (see tg_candidates)."""
        parents = np.ascontiguousarray(parents, dtype=np.int64)
        cap = max(len(parents) * cam_mask.shape[1] * 4, 64)
        while True:
            op = np.empty(cap, dtype=np.int64)
            oc = np.empty(cap, dtype=np.int32)
            ox = np.empty(cap, dtype=np.int32)
            oy = np.empty(cap, dtype=np.int32)
            n = self._lib.tg_candidates(
                self._g, parents, len(parents),
                np.ascontiguousarray(centers, dtype=np.float64),
                np.ascontiguousarray(normal_sph, dtype=np.float64),
                np.ascontiguousarray(correlation, dtype=np.float64),
                np.ascontiguousarray(alive, dtype=np.uint8),
                np.ascontiguousarray(cam_mask, dtype=np.uint8),
                np.ascontiguousarray(img_pts, dtype=np.float64),
                float(min_correlation), float(neighbor_radius),
                int(max_cell_patch_num), op, oc, ox, oy, cap)
            if n >= 0:
                return op[:n], oc[:n], ox[:n], oy[:n]
            cap *= 2

    @staticmethod
    def _keys_arrays(keys):
        k = np.asarray(keys, dtype=np.int32).reshape(-1, 3)
        return (np.ascontiguousarray(k[:, 0]), np.ascontiguousarray(k[:, 1]),
                np.ascontiguousarray(k[:, 2]))

    def cell_filter(self, keys, correlation, cam_mask, img_pts, alive):
        """Whole cellFiltering pass (tg_cell_filter). Mutates ``alive`` and
        the grid; returns the killed ids."""
        oc, ox, oy = self._keys_arrays(keys)
        out = np.empty(max(len(alive), 1), dtype=np.int64)
        n = self._lib.tg_cell_filter(
            self._g, oc, ox, oy, len(oc),
            np.ascontiguousarray(correlation, dtype=np.float64),
            np.ascontiguousarray(cam_mask, dtype=np.uint8),
            np.ascontiguousarray(img_pts, dtype=np.float64),
            alive, out, len(out))
        return out[:n]

    def visibility_filter(self, ids, centers, cam_centers, cam_mask,
                          img_pts, alive, min_cam_num: int):
        """Whole visibilityFiltering pass (tg_visibility_filter)."""
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        out = np.empty(max(len(ids), 1), dtype=np.int64)
        n = self._lib.tg_visibility_filter(
            self._g, ids, len(ids),
            np.ascontiguousarray(centers, dtype=np.float64),
            np.ascontiguousarray(cam_centers, dtype=np.float64),
            np.ascontiguousarray(cam_mask, dtype=np.uint8),
            np.ascontiguousarray(img_pts, dtype=np.float64),
            alive, int(min_cam_num), out, len(out))
        return out[:n]

    def neighbor_cell_filter(self, keys, centers, normal_sph, cam_mask,
                             img_pts, alive, neighbor_radius: float,
                             ratio: float):
        """Whole neighborCellFiltering pass (tg_neighbor_cell_filter)."""
        oc, ox, oy = self._keys_arrays(keys)
        out = np.empty(max(len(alive), 1), dtype=np.int64)
        n = self._lib.tg_neighbor_cell_filter(
            self._g, oc, ox, oy, len(oc),
            np.ascontiguousarray(centers, dtype=np.float64),
            np.ascontiguousarray(normal_sph, dtype=np.float64),
            np.ascontiguousarray(cam_mask, dtype=np.uint8),
            np.ascontiguousarray(img_pts, dtype=np.float64),
            alive, float(neighbor_radius), float(ratio), out, len(out))
        return out[:n]

    def batch_insert(self, order, keep, cam_masks, img_pts,
                     parents, cand_cam, cand_cx, cand_cy,
                     centers, normal_sph, correlation, alive,
                     cand_center, cand_sph, cand_corr,
                     min_correlation: float, neighbor_radius: float,
                     max_cell_patch_num: int, first_id: int):
        """Sequential insert-time density + skipNeighborCell re-check +
        grid registration for one expansion round (tg_batch_insert).
        Returns the acceptance mask in candidate order; accepted rows got
        ids first_id..first_id+n-1 in ``order`` sequence."""
        order = np.ascontiguousarray(order, dtype=np.int64)
        accept = np.zeros(len(keep), dtype=np.uint8)
        self._lib.tg_batch_insert(
            self._g, order, len(order),
            np.ascontiguousarray(keep, dtype=np.uint8),
            np.ascontiguousarray(cam_masks, dtype=np.uint8),
            np.ascontiguousarray(img_pts, dtype=np.float64),
            np.ascontiguousarray(parents, dtype=np.int64),
            np.ascontiguousarray(cand_cam, dtype=np.int32),
            np.ascontiguousarray(cand_cx, dtype=np.int32),
            np.ascontiguousarray(cand_cy, dtype=np.int32),
            np.ascontiguousarray(centers, dtype=np.float64),
            np.ascontiguousarray(normal_sph, dtype=np.float64),
            np.ascontiguousarray(correlation, dtype=np.float64),
            np.ascontiguousarray(alive, dtype=np.uint8),
            np.ascontiguousarray(cand_center, dtype=np.float64),
            np.ascontiguousarray(cand_sph, dtype=np.float64),
            np.ascontiguousarray(cand_corr, dtype=np.float64),
            float(min_correlation), float(neighbor_radius),
            int(max_cell_patch_num), int(first_id), accept)
        return accept.astype(bool)

    @staticmethod
    def build(arena, widths, heights, cell_size: int) -> "NativeCellGrids":
        g = NativeCellGrids(widths, heights, cell_size)
        for pid in arena.live_ids():
            g.insert_patch(int(pid), arena.data["cam_mask"][pid],
                           arena.data["img_point"][pid])
        return g


def neighbor_counts(centers: np.ndarray, ids: np.ndarray,
                    radius: float) -> np.ndarray:
    """Euclidean neighbour counts within radius, grid-hashed (C++)."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    out = np.zeros(len(ids), dtype=np.int64)
    lib().tg_neighbor_counts(
        np.ascontiguousarray(centers, dtype=np.float64), ids, len(ids),
        float(radius), out)
    return out
