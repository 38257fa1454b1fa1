"""Per-camera cell grids: the spatial index driving expansion & filtering.

The port's copy of ``pais_mvs_tpu/engine/cellgrid.py`` (host numpy, no
framework). Ref: CellMap (TMVS/mvs/cellmap.{h,cpp}) — a ceil(img/cellSize)
grid of patch-id buckets per camera. Host-side structure (the heavy math stays on
device); buckets are unbounded like the reference's vectors — the
``maxCellPatchNum`` cap is enforced by the expansion/filter logic, not by
the container.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


class GridCoordsMixin:
    """Shared coordinate math for the Python and native cell grids.

    One copy ONLY: the native/Python bit-parity requirement means any
    drift between the two grids' coordinate conventions (e.g. int()
    truncation vs floor — identical here because runtime filtering
    guarantees non-negative in-frame image points for registered
    patches, mirroring the reference's (int) casts in cellmap.cpp)
    silently breaks the parity tests."""

    cell_size: int

    @staticmethod
    def grid_dims(sizes, cell_size: int):
        return [int(math.ceil(s / cell_size)) for s in sizes]

    def in_map(self, cam: int, cx: int, cy: int) -> bool:
        return 0 <= cx < self.width[cam] and 0 <= cy < self.height[cam]

    def cell_of(self, img_point) -> Tuple[int, int]:
        return (int(img_point[0] / self.cell_size),
                int(img_point[1] / self.cell_size))


class CellGrids(GridCoordsMixin):
    def __init__(self, widths, heights, cell_size: int):
        self.cell_size = cell_size
        self.width = self.grid_dims(widths, cell_size)
        self.height = self.grid_dims(heights, cell_size)
        self.cells: Dict[Tuple[int, int, int], List[int]] = {}

    def cell(self, cam: int, cx: int, cy: int) -> List[int]:
        return self.cells.get((cam, cx, cy), [])

    def all_keys(self):
        """Sorted (cam, cx, cy) keys of every non-empty cell."""
        return sorted(k for k, v in self.cells.items() if v)

    def insert(self, cam: int, cx: int, cy: int, pid: int) -> None:
        self.cells.setdefault((cam, cx, cy), []).append(pid)

    def insert_patch(self, pid: int, cam_mask, img_points) -> None:
        for cam in np.nonzero(cam_mask)[0]:
            cx, cy = self.cell_of(img_points[cam])
            if self.in_map(cam, cx, cy):
                self.insert(int(cam), cx, cy, int(pid))

    def remove_patch(self, pid: int, cam_mask, img_points) -> None:
        for cam in np.nonzero(cam_mask)[0]:
            cx, cy = self.cell_of(img_points[cam])
            lst = self.cells.get((int(cam), cx, cy))
            if lst and pid in lst:
                lst.remove(pid)

    @staticmethod
    def build(arena, widths, heights, cell_size: int) -> "CellGrids":
        """MVS::setCellMaps (mvs.cpp:116-133): project every live patch into
        its visible cameras' grids."""
        g = CellGrids(widths, heights, cell_size)
        for pid in arena.live_ids():
            g.insert_patch(int(pid), arena.data["cam_mask"][pid],
                           arena.data["img_point"][pid])
        return g
