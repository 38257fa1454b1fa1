"""Configuration system.

Covers every knob of the reference ``MvsConfig`` (TMVS/mvs/mvs.h:19-72) with
the compiled-in defaults of ``setInitConfig`` (TMVS/TMVS.cpp:26-52) and the
``config.txt`` key/value parser (TMVS/io/fileloader.cpp:474-564).

Unlike the reference — where config lives inside a process-wide singleton
that every layer reads back through ``MVS::getInstance()`` — the config here
is an explicit immutable object threaded down through the pipeline.

The PyTorch port's copy of ``pais_mvs_tpu/config.py``: the same knobs,
parser and binary blob, minus the TPU kernel knobs (``fitness_backend`` and
``pallas_*``). The port dispatches each kernel by the device of its tensors.
"""

from __future__ import annotations

import dataclasses
import struct
from dataclasses import dataclass

# Expansion strategies (TMVS/mvs/mvs.h:162-166).
EXPANSION_BEST_FIRST = 0
EXPANSION_WORST_FIRST = 1
EXPANSION_BREADTH_FIRST = 2
EXPANSION_DEPTH_FIRST = 3


@dataclass(frozen=True)
class MvsConfig:
    """All reconstruction knobs. Defaults mirror TMVS/TMVS.cpp:26-52."""

    # -- image cell grid --------------------------------------------------
    cell_size: int = 4                  # image cell size in pixels
    max_cell_patch_num: int = 3         # density cap per cell

    # -- patch window ------------------------------------------------------
    patch_radius: int = 15              # window = (2r+1)^2 pixels

    # -- visibility --------------------------------------------------------
    min_cam_num: int = 3
    visible_correlation: float = 0.7    # viewing-cone gate for expansion
    min_correlation: float = 0.7        # NCC gate / runtime filter
    min_region_ratio: float = 0.55      # warped-window anisotropy gate

    # -- photoconsistency weighting ---------------------------------------
    adaptive_distance_enable: bool = True
    adaptive_difference_enable: bool = True
    adaptive_gradient_enable: bool = False
    dist_weighting: float = 5.0         # Gaussian sigma (default radius/3)
    diff_weighting: float = 128.0 * 128.0
    gradient_weighting: float = 10.0

    # -- level of detail ---------------------------------------------------
    texture_variation: float = 36.0
    min_lod: int = 0
    max_lod: int = 15
    lod_ratio: float = 0.8

    # -- optimization ------------------------------------------------------
    max_fitness: float = 10.0
    reduce_normal_range: float = 2.0    # expansion search shrink: +-pi/range
    depth_range_scalar: float = 1.0
    particle_num: int = 5
    max_iteration: int = 10

    # -- neighborhood geometry ----------------------------------------------
    neighbor_radius: float = 0.005      # recomputed from bounding volume
    neighbor_radius_scalar: float = 0.0025

    # -- expansion ordering --------------------------------------------------
    expansion_strategy: int = EXPANSION_BEST_FIRST

    # ---- engine-only knobs (no reference counterpart) ---------------------
    # Patches refined per device batch; swarms run in lockstep.
    batch_size: int = 1024
    # Wavefront round size (frontier patches expanded per round). A value of
    # 1 degenerates toward the reference's strictly-ordered expansion.
    wavefront_size: int = 4096
    # Fixed visible-camera-set / reference-camera re-optimisation rounds for
    # seed patches (the reference loops until stable, <= camNum times).
    seed_refine_rounds: int = 3
    # Deterministic RNG seed (the reference uses srand(time) — irreproducible).
    rng_seed: int = 0
    # Multi-device patch-axis data parallelism: "auto"/"on"/"off". Parsed
    # so one config.txt serves both packages; this package runs on one
    # device for now and does not read it.
    data_parallel: str = "auto"
    # undistort input images + measurements at load so the engine runs pure
    # pinhole (the reference parses NVM radial distortion but never enables
    # it at any project() call site; camera.cpp:148-155)
    apply_distortion: bool = False
    # GLN-PSO iteration-loop chunk size for whole-batch early exit: > 0
    # runs the PSO iterations in chunks of this many and stops once EVERY
    # swarm has frozen (the batch analog of the reference's per-swarm early
    # stop, psosolver.cpp:286-306). Bit-identical to the fixed-length loop
    # (frozen swarms never move; ops/pso.py). Each chunk boundary costs one
    # device-to-host read. 0 = fixed-length loop (default).
    pso_exit_chunk: int = 0
    # Pipelined wavefront expansion: overlap the HOST candidate generation
    # of round n+1 with the DEVICE refine of round n (the largest
    # non-kernel expansion line item: 30 s host vs 482 s device at 4K,
    # strictly alternating — BASELINE.md round 4). Candidates of round
    # n+1 are generated against the pre-insert(n) grid; the insert-time
    # live-grid re-check restores density/skipNeighborCell verdicts
    # exactly, and round-n inserts join the frontier one round later —
    # both shifts are of the wavefront-size-tuning class (CI parity gate:
    # tests/test_engine_e2e.py). Off by default so the host path stays a
    # bit-exact serial-order mirror for the oracle-parity suites.
    pipeline_expansion: bool = False

    @property
    def patch_size(self) -> int:
        return 2 * self.patch_radius + 1

    def replace(self, **kw) -> "MvsConfig":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        """Startup banner listing every knob (the reference's printConfig,
        TMVS/mvs/mvs.cpp:900-955)."""
        lines = ["MVS config:"]
        for f in dataclasses.fields(self):
            lines.append(f"  {f.name:26s} {getattr(self, f.name)}")
        return "\n".join(lines)


# Mapping of config.txt keys (reference spelling) to dataclass fields and
# value parsers (TMVS/io/fileloader.cpp:490-560).
_TXT_KEYS = {
    "patchRadius": ("patch_radius", int),
    "reduceNormalRange": ("reduce_normal_range", float),
    "adaptiveDistanceEnable": ("adaptive_distance_enable", lambda s: bool(int(s))),
    "adaptiveDifferenceEnable": ("adaptive_difference_enable", lambda s: bool(int(s))),
    "adaptiveGradientEnable": ("adaptive_gradient_enable", lambda s: bool(int(s))),
    "distWeighting": ("dist_weighting", float),
    "diffWeighting": ("diff_weighting", float),
    "visibleCorrelation": ("visible_correlation", float),
    "depthRangeScalar": ("depth_range_scalar", float),
    "particleNum": ("particle_num", int),
    "maxIteration": ("max_iteration", int),
    "cellSize": ("cell_size", int),
    "maxCellPatchNum": ("max_cell_patch_num", int),
    "expansionStrategy": ("expansion_strategy", int),
    "textureVariation": ("texture_variation", float),
    "minLOD": ("min_lod", int),
    "maxLOD": ("max_lod", int),
    "lodRatio": ("lod_ratio", float),
    "minCamNum": ("min_cam_num", int),
    "minCorrelation": ("min_correlation", float),
    "minRegionRatio": ("min_region_ratio", float),
    "maxFitness": ("max_fitness", float),
    "neighborRadiusScalar": ("neighbor_radius_scalar", float),
    # engine-only extensions (accepted in the same file format)
    "batchSize": ("batch_size", int),
    "wavefrontSize": ("wavefront_size", int),
    "seedRefineRounds": ("seed_refine_rounds", int),
    "rngSeed": ("rng_seed", int),
    "applyDistortion": ("apply_distortion", lambda v: bool(int(v))),
    "dataParallel": ("data_parallel", str),
    "psoExitChunk": ("pso_exit_chunk", int),
    "pipelineExpansion": ("pipeline_expansion", lambda v: bool(int(v))),
}


def load_config_txt(path: str, base: MvsConfig | None = None) -> MvsConfig:
    """Parse a reference-style ``config.txt`` (``#`` comments, key value)."""
    cfg = base or MvsConfig()
    updates = {}
    with open(path, "r") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            key = parts[0]
            if key in _TXT_KEYS:
                field, conv = _TXT_KEYS[key]
                updates[field] = conv(parts[1])
    return cfg.replace(**updates)


# --------------------------------------------------------------------------
# Binary layout of the reference MvsConfig struct, as memcpy'd into .mvs
# files (TMVS/io/filewriter.cpp:3-6 / fileloader.cpp:167-171). MSVC layout:
# doubles 8-aligned, bools 1 byte, trailing pad to 8.
#   0: int32 cellSize, patchRadius, patchSize, minCamNum
#  16: f64 textureVariation, visibleCorrelation, minCorrelation, maxFitness,
#      lodRatio
#  56: int32 minLOD, maxLOD, maxCellPatchNum, (4 pad)
#  72: f64 reduceNormalRange
#  80: bool x3 adaptiveDistance/Difference/Gradient, (5 pad)
#  88: f64 distWeighting, diffWeighting, gradientWeighting, neighborRadius,
#      neighborRadiusScalar, minRegionRatio, depthRangeScalar
# 144: int32 particleNum, maxIteration, expansionStrategy, (4 pad)
# 160: end
# --------------------------------------------------------------------------
_BIN_FMT = "<4i5d3i4x d 3?5x 7d 3i4x"
MVS_CONFIG_STRUCT_SIZE = struct.calcsize(_BIN_FMT)
assert MVS_CONFIG_STRUCT_SIZE == 160


def pack_config_binary(cfg: MvsConfig) -> bytes:
    """Serialize to the reference's raw-struct layout for .mvs files."""
    return struct.pack(
        _BIN_FMT,
        cfg.cell_size, cfg.patch_radius, cfg.patch_size, cfg.min_cam_num,
        cfg.texture_variation, cfg.visible_correlation, cfg.min_correlation,
        cfg.max_fitness, cfg.lod_ratio,
        cfg.min_lod, cfg.max_lod, cfg.max_cell_patch_num,
        cfg.reduce_normal_range,
        cfg.adaptive_distance_enable, cfg.adaptive_difference_enable,
        cfg.adaptive_gradient_enable,
        cfg.dist_weighting, cfg.diff_weighting, cfg.gradient_weighting,
        cfg.neighbor_radius, cfg.neighbor_radius_scalar,
        cfg.min_region_ratio, cfg.depth_range_scalar,
        cfg.particle_num, cfg.max_iteration, cfg.expansion_strategy,
    )


def unpack_config_binary(buf: bytes, base: MvsConfig | None = None) -> MvsConfig:
    """Deserialize a reference raw-struct config blob."""
    v = struct.unpack(_BIN_FMT, buf[:MVS_CONFIG_STRUCT_SIZE])
    cfg = base or MvsConfig()
    return cfg.replace(
        cell_size=v[0], patch_radius=v[1], min_cam_num=v[3],
        texture_variation=v[4], visible_correlation=v[5],
        min_correlation=v[6], max_fitness=v[7], lod_ratio=v[8],
        min_lod=v[9], max_lod=v[10], max_cell_patch_num=v[11],
        reduce_normal_range=v[12],
        adaptive_distance_enable=v[13], adaptive_difference_enable=v[14],
        adaptive_gradient_enable=v[15],
        dist_weighting=v[16], diff_weighting=v[17], gradient_weighting=v[18],
        neighbor_radius=v[19], neighbor_radius_scalar=v[20],
        min_region_ratio=v[21], depth_range_scalar=v[22],
        particle_num=v[23], max_iteration=v[24], expansion_strategy=v[25],
    )
