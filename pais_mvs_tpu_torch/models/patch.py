"""Patch state as a fixed-capacity struct-of-tensors batch.

The PyTorch counterpart of ``pais_mvs_tpu/models/patch.py``. The reference's
central data structure is a heap-allocated ``Patch`` object per point,
stored in a ``map<int, Patch>`` (TMVS/mvs/abstractpatch.h:20-53). Here a
batch of patches is one dataclass of ``[B, ...]`` tensors with a validity
mask, so every lifecycle op is a masked tensor program.

Per-patch visible cameras are a dense boolean mask over the (small) camera
axis instead of a ragged index list.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from pais_mvs_tpu_torch import resolve_device


@dataclass
class PatchBatch:
    """A batch of B patches against a C-camera rig."""

    center: torch.Tensor       # [B, 3] f32 world position
    normal_sph: torch.Tensor   # [B, 2] f32 (theta, phi)
    cam_mask: torch.Tensor     # [B, C] bool visibility
    ref_cam: torch.Tensor      # [B] int32 reference camera index
    depth: torch.Tensor        # [B] f32 distance from reference camera
    ray: torch.Tensor          # [B, 3] f32 unit ray from reference camera
    depth_range: torch.Tensor  # [B, 2] f32 (lo, hi) PSO depth bounds
    lod: torch.Tensor          # [B] int32 pyramid level
    fitness: torch.Tensor      # [B] f32 (lower = better)
    correlation: torch.Tensor  # [B] f32 mean pairwise NCC
    priority: torch.Tensor     # [B] f32 (lower = better)
    color: torch.Tensor        # [B, 3] f32 RGB 0..255
    img_point: torch.Tensor    # [B, C, 2] f32 level-0 projections
    valid: torch.Tensor        # [B] bool alive flag (not dropped)
    expanded: torch.Tensor     # [B] bool already used as expansion parent
    is_seed: torch.Tensor      # [B] bool seed (vs expansion) patch

    @property
    def capacity(self) -> int:
        return self.center.shape[0]

    @property
    def num_cameras(self) -> int:
        return self.cam_mask.shape[1]

    @property
    def device(self) -> torch.device:
        return self.center.device

    def normal(self):
        from pais_mvs_tpu_torch.ops import geometry
        return geometry.spherical_to_normal(self.normal_sph)

    def cam_count(self):
        return self.cam_mask.sum(-1).to(torch.int32)

    def replace(self, **kw) -> "PatchBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PatchBatch":
        return _map(lambda t: t.to(device), self)

    def numpy(self) -> dict:
        """Host copy as a dict of numpy arrays (field name -> array)."""
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


def _map(fn, *batches: PatchBatch) -> PatchBatch:
    return PatchBatch(**{f.name: fn(*(getattr(b, f.name) for b in batches))
                         for f in dataclasses.fields(PatchBatch)})


def empty_batch(capacity: int, num_cams: int, device="cuda") -> PatchBatch:
    device = resolve_device(device)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return PatchBatch(
        center=z(capacity, 3), normal_sph=z(capacity, 2),
        cam_mask=zb(capacity, num_cams), ref_cam=zi(capacity),
        depth=z(capacity), ray=z(capacity, 3), depth_range=z(capacity, 2),
        lod=zi(capacity), fitness=z(capacity), correlation=z(capacity),
        priority=z(capacity), color=z(capacity, 3),
        img_point=z(capacity, num_cams, 2), valid=zb(capacity),
        expanded=zb(capacity), is_seed=zb(capacity),
    )


def from_seeds(centers: np.ndarray, cam_masks: np.ndarray,
               img_points: np.ndarray | None = None,
               colors: np.ndarray | None = None,
               device="cuda") -> PatchBatch:
    """Build a seed batch from triangulated points.

    Args:
      centers: [B, 3]; cam_masks: [B, C] bool;
      img_points: [B, C, 2] measured pixel positions (level 0) or None;
      colors: [B, 3] RGB or None.
    """
    device = resolve_device(device)
    B, C = np.shape(cam_masks)
    pb = empty_batch(B, C, device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                    device=device)
    return pb.replace(
        center=f32(centers),
        cam_mask=torch.as_tensor(np.asarray(cam_masks, dtype=bool),
                                 device=device),
        img_point=f32(img_points) if img_points is not None else pb.img_point,
        color=f32(colors) if colors is not None else pb.color,
        valid=torch.ones(B, dtype=torch.bool, device=device),
        is_seed=torch.ones(B, dtype=torch.bool, device=device),
    )


def concat(a: PatchBatch, b: PatchBatch) -> PatchBatch:
    return _map(lambda x, y: torch.cat([x, y], dim=0), a, b)


def take(pb: PatchBatch, idx) -> PatchBatch:
    if torch.is_tensor(idx):
        idx = idx.to(pb.device, torch.long)
    else:
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64),
                              device=pb.device)
    return _map(lambda x: x[idx], pb)
