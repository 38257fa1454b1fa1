"""PyTorch port: config parity with the JAX package, import isolation, and
the device rule of the entry points."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pais_mvs_tpu import config as jcfg
from pais_mvs_tpu_torch import config as tcfg
import torch_parity  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CONFIG_TXT = """# reference-style config.txt
patchRadius 7
reduceNormalRange 3.0
adaptiveDistanceEnable 1
adaptiveDifferenceEnable 0
adaptiveGradientEnable 1
distWeighting 2.5
diffWeighting 4096
visibleCorrelation 0.6
depthRangeScalar 1.5
particleNum 9
maxIteration 17
cellSize 6
maxCellPatchNum 2
expansionStrategy 2
textureVariation 30
minLOD 1
maxLOD 5
lodRatio 0.75
minCamNum 2
minCorrelation 0.65
minRegionRatio 0.5
maxFitness 12
neighborRadiusScalar 0.003
batchSize 256
wavefrontSize 512
seedRefineRounds 2
rngSeed 7
applyDistortion 1
dataParallel off
psoExitChunk 5
pipelineExpansion 1
"""


def test_config_txt_parses_to_equal_fields_and_blob(tmp_path):
    """The same config.txt gives equal shared fields (exact: both parse
    with the same Python conversions) and a byte-equal reference struct
    blob."""
    path = tmp_path / "config.txt"
    path.write_text(_CONFIG_TXT)
    a = jcfg.load_config_txt(str(path))
    b = tcfg.load_config_txt(str(path))
    shared = [f for f in b.__dataclass_fields__ if f in a.__dataclass_fields__]
    assert len(shared) == len(b.__dataclass_fields__)
    for name in shared:
        assert getattr(a, name) == getattr(b, name), name
    assert tcfg.MVS_CONFIG_STRUCT_SIZE == jcfg.MVS_CONFIG_STRUCT_SIZE
    blob = tcfg.pack_config_binary(b)
    assert blob == jcfg.pack_config_binary(a)
    assert tcfg.pack_config_binary(tcfg.unpack_config_binary(blob)) == blob
    assert "patch_radius" in b.describe()
    assert not hasattr(b, "fitness_backend")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter with jax, flax and pais_mvs_tpu blocked; the walk reaches
    the view-sharded path, the SPMD expansion, the microbench tool, the
    host engine's cell grids and native runtime, the file formats, feature
    seeding, bundle adjustment, the diagnostics and the CLI."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        BLOCK = ("jax", "jaxlib", "flax", "pais_mvs_tpu")
        for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
            del sys.modules[m]
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCK:
                    raise ImportError("the port imported " + name)
        sys.meta_path.insert(0, Block())
        import pais_mvs_tpu_torch
        for mi in pkgutil.walk_packages(pais_mvs_tpu_torch.__path__,
                                        "pais_mvs_tpu_torch."):
            importlib.import_module(mi.name)
        import chip_smoke
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCK]
        assert not bad, bad
        need = ["pais_mvs_tpu_torch." + m for m in (
            "ops.view_fitness", "parallel.mesh", "parallel.distributed",
            "parallel.sharded", "parallel.expansion",
            "tools.microbench_kernel", "engine.cellgrid",
            "native", "io.nvm", "io.mvsbin", "io.logmanager", "cli",
            "features.seeding", "ops.bundle", "diagnostics")]
        assert all(m in sys.modules for m in need), need
        print("isolated")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "isolated" in r.stdout


def test_precision_pins():
    import pais_mvs_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_default_to_cuda_and_raise_without_it(tiny_scene):
    import pais_mvs_tpu_torch as P
    from pais_mvs_tpu_torch.models.camera import build_scene
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    if torch.cuda.is_available():
        assert P.default_device().type == "cuda"
        return
    cfg = tcfg.MvsConfig(patch_radius=3, max_lod=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.default_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        build_scene(tiny_scene.params, tiny_scene.images, cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        Reconstructor(tiny_scene.params, tiny_scene.images, cfg)
    # an explicit CPU request runs
    sc = build_scene(tiny_scene.params, tiny_scene.images, cfg, device="cpu")
    assert sc.device.type == "cpu"
    assert np.isfinite(sc.rig.R.numpy()).all()


@pytest.mark.parametrize("ctor", ["from_seeds", "empty_batch",
                                  "scene_from_numpy", "patch_batch_from_numpy",
                                  "draw_uniforms"])
def test_constructors_default_to_cuda_and_raise_without_it(tiny_scene, ctor):
    """State enters the port on the GPU unless the caller asks for the CPU:
    no constructor builds CPU tensors silently."""
    if torch.cuda.is_available():
        pytest.skip("the default is usable with a GPU present")
    from pais_mvs_tpu_torch import convert
    from pais_mvs_tpu_torch.models import patch as tpm
    from pais_mvs_tpu_torch.ops import pso
    seeds = (tiny_scene.seed_centers, tiny_scene.seed_cam_masks)
    batch = tpm.from_seeds(*seeds, device="cpu")
    calls = {
        "from_seeds": lambda **kw: tpm.from_seeds(*seeds, **kw),
        "empty_batch": lambda **kw: tpm.empty_batch(4, 3, **kw),
        "scene_from_numpy": lambda **kw: convert.scene_from_numpy(
            {"rig": {}, "pyramids": {}}, **kw),
        "patch_batch_from_numpy": lambda **kw: convert.patch_batch_from_numpy(
            batch.numpy(), **kw),
        "draw_uniforms": lambda **kw: pso.draw_uniforms(2, 3, 3, 4, **kw),
    }
    with pytest.raises(RuntimeError, match="no GPU"):
        calls[ctor]()
    if ctor != "scene_from_numpy":
        out = calls[ctor](device="cpu")
        first = out[0] if isinstance(out, tuple) else out.center
        assert first.device.type == "cpu"
