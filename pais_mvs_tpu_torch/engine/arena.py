"""Host-side patch arena: the growable struct-of-arrays store.

The device works on fixed-shape ``PatchBatch`` slices; the arena owns the
full, growing patch set between device calls (the reference's
``map<int, Patch>``, TMVS/mvs/mvs.h:83-94, replaced by flat numpy arrays
with O(1) id indexing). Deleted patches are archived, mirroring the
reference's ``deletedPatches`` diagnostics container.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


_FIELDS = {
    "center": (3, np.float64),
    "normal_sph": (2, np.float64),
    "cam_mask": (None, bool),          # [C]
    "ref_cam": ((), np.int32),
    "depth": ((), np.float64),
    "lod": ((), np.int32),
    "fitness": ((), np.float64),
    "correlation": ((), np.float64),
    "priority": ((), np.float64),
    "color": (3, np.float64),
    "img_point": (None, np.float64),   # [C, 2]
    "is_seed": ((), bool),
}


class PatchArena:
    def __init__(self, num_cams: int, capacity: int = 1024):
        self.num_cams = num_cams
        self._cap = capacity
        self.count = 0
        self.data: Dict[str, np.ndarray] = {}
        for name, (dim, dt) in _FIELDS.items():
            shape = self._shape(name, dim, capacity)
            self.data[name] = np.zeros(shape, dtype=dt)
        self.alive = np.zeros(capacity, dtype=bool)
        self.expanded = np.zeros(capacity, dtype=bool)
        self.deleted_ids: List[int] = []

    def _shape(self, name, dim, n):
        if name == "cam_mask":
            return (n, self.num_cams)
        if name == "img_point":
            return (n, self.num_cams, 2)
        if dim == ():
            return (n,)
        return (n, dim)

    def _grow(self, need: int):
        while self._cap < need:
            self._cap *= 2
        for name, arr in self.data.items():
            if arr.shape[0] < self._cap:
                new = np.zeros((self._cap,) + arr.shape[1:], dtype=arr.dtype)
                new[:arr.shape[0]] = arr
                self.data[name] = new
        for attr in ("alive", "expanded"):
            arr = getattr(self, attr)
            if arr.shape[0] < self._cap:
                new = np.zeros(self._cap, dtype=bool)
                new[:arr.shape[0]] = arr
                setattr(self, attr, new)

    def append(self, **fields) -> np.ndarray:
        """Append patches (all arrays share leading dim N); returns ids."""
        n = len(fields["center"])
        ids = np.arange(self.count, self.count + n)
        self._grow(self.count + n)
        for name, val in fields.items():
            self.data[name][ids] = val
        self.alive[ids] = True
        self.count += n
        return ids

    def delete(self, ids) -> None:
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        live = ids[self.alive[ids]]
        self.alive[live] = False
        self.deleted_ids.extend(int(i) for i in live)

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.alive[:self.count])[0]

    def __getattr__(self, name):
        data = object.__getattribute__(self, "data")
        if name in data:
            return data[name][:object.__getattribute__(self, "count")]
        raise AttributeError(name)

    def normals(self, ids) -> np.ndarray:
        sph = self.data["normal_sph"][ids]
        st = np.sin(sph[:, 0])
        return np.stack([st * np.cos(sph[:, 1]), st * np.sin(sph[:, 1]),
                         np.cos(sph[:, 0])], axis=-1)

    def bounding_volume(self) -> float:
        """|extent_x * extent_y * extent_z| of live patch centers
        (MVS::getBoundingVolume, mvs.cpp:974-997)."""
        ids = self.live_ids()
        if len(ids) == 0:
            return 0.0
        c = self.data["center"][ids]
        ext = c.max(axis=0) - c.min(axis=0)
        return float(abs(ext[0] * ext[1] * ext[2]))

    def neighbor_radius(self, scalar: float) -> float:
        """volume^(1/3) * neighborRadiusScalar (MVS::setNeighborRadius,
        mvs.cpp:147-152)."""
        return self.bounding_volume() ** (1.0 / 3.0) * scalar
