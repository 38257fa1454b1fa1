"""Scene renderers, one module per kind (``scenes/<kind>.py``), found by
the ``scene`` key of a configuration file. Each module has
``render(cfg, seed, device) -> Scene``: the same seed gives the same
scene. ``write_files`` writes what the program's CLI reads: one PNG per
camera, ``scene.nvm`` (NVM_V3, image points centre-origin) and
``config.txt``.

A ``Scene`` carries its analytic surface: ``surface.cast(o, dirs)`` (the
nearest hit of rays) and ``surface.distance(X)``, which the reference
uses to judge the cloud's geometry.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Any, List

import numpy as np


def _g9(x: float) -> float:
    """``x`` as the NVM file holds it (nine significant digits)."""
    return float(f"{float(x):.9g}")


@dataclasses.dataclass
class Camera:
    name: str
    focal: float
    quaternion: np.ndarray     # w, x, y, z
    center: np.ndarray
    radial: float
    width: int
    height: int

    def __post_init__(self):
        # the numbers as the NVM file gives them to the program
        self.focal = _g9(self.focal)
        self.quaternion = np.array([_g9(v) for v in self.quaternion])
        self.center = np.array([_g9(v) for v in self.center])
        self.radial = _g9(self.radial)


@dataclasses.dataclass
class Scene:
    cameras: List[Camera]
    images: List[np.ndarray]          # uint8 [H, W, 3]
    seed_points: np.ndarray           # [M, 3]
    seed_masks: np.ndarray            # [M, C] bool
    seed_pixels: np.ndarray           # [M, C, 2], top-left origin
    surface: Any


def render(kind: str, cfg: dict, seed: int, device=None) -> Scene:
    return importlib.import_module(f"benchmark.scenes.{kind}").render(
        cfg, seed, device)


def config_txt(cfg: dict) -> str:
    return "".join(f"{k} {v}\n" for k, v in cfg["config_txt"].items())


def write_nvm(path: str, scene: Scene) -> None:
    """NVM_V3: one line per camera (name, focal, quaternion, centre,
    radial distortion), then the points with their measurements in
    centre-origin pixels."""
    lines = ["NVM_V3 ", "", str(len(scene.cameras))]
    for c in scene.cameras:
        q, x = c.quaternion, c.center
        lines.append(f"{c.name}\t{c.focal:.9g} {q[0]:.9g} {q[1]:.9g} "
                     f"{q[2]:.9g} {q[3]:.9g} {x[0]:.9g} {x[1]:.9g} "
                     f"{x[2]:.9g} {c.radial:.9g} 0")
    lines += ["", str(len(scene.seed_points))]
    for m, p in enumerate(scene.seed_points):
        views = np.nonzero(scene.seed_masks[m])[0]
        row = f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g} 128 128 128 {len(views)}"
        for ci in views:
            cam = scene.cameras[ci]
            u = scene.seed_pixels[m, ci, 0] - (cam.width // 2)
            v = scene.seed_pixels[m, ci, 1] - (cam.height // 2)
            row += f" {ci} {m} {u:.9g} {v:.9g}"
        lines.append(row)
    lines += ["", "0", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_files(scene: Scene, cfg: dict, out_dir: str) -> str:
    """The PNGs (zlib level 1), ``scene.nvm`` and ``config.txt`` in
    ``out_dir``; returns the NVM's path."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    for cam, img in zip(scene.cameras, scene.images):
        Image.fromarray(img).save(os.path.join(out_dir, cam.name),
                                  compress_level=1)
    path = os.path.join(out_dir, "scene.nvm")
    write_nvm(path, scene)
    with open(os.path.join(out_dir, "config.txt"), "w") as f:
        f.write(config_txt(cfg))
    return path
