"""State carried across from the JAX package: its ``Scene`` and
``PatchBatch`` as numpy arrays, turned into this package's objects.

The system has no weights; its state is the scene (camera rig + packed
pyramid atlases) and the patch batch. The JAX package's pytrees come across
as nested mappings of numpy arrays (for example ``dataclasses.asdict`` of
``jax.device_get(scene)``); this module needs neither JAX nor
``pais_mvs_tpu``. bf16 arrays (numpy's ``ml_dtypes`` bfloat16) are carried
bit for bit, so both packages score the very same atlas.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from pais_mvs_tpu_torch import resolve_device
from pais_mvs_tpu_torch.models.camera import CameraRig, PyramidSet, Scene
from pais_mvs_tpu_torch.models.patch import PatchBatch


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy array -> tensor of the same dtype; bf16 keeps its bits."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _fields(cls, d: Mapping, device) -> dict:
    return {f.name: tensor_from_numpy(d[f.name], device)
            for f in dataclasses.fields(cls)}


def scene_from_numpy(d: Mapping, device="cuda") -> Scene:
    """``{"rig": {...}, "pyramids": {...}}`` of numpy arrays -> Scene."""
    device = resolve_device(device)
    return Scene(rig=CameraRig(**_fields(CameraRig, d["rig"], device)),
                 pyramids=PyramidSet(**_fields(PyramidSet, d["pyramids"],
                                               device)))


def patch_batch_from_numpy(d: Mapping, device="cuda") -> PatchBatch:
    """``{field: array}`` of a JAX ``PatchBatch`` -> PatchBatch."""
    device = resolve_device(device)
    return PatchBatch(**_fields(PatchBatch, d, device))
