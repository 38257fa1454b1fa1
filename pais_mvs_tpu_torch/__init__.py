"""pais_mvs_tpu_torch — the PyTorch/CUDA port of ``pais_mvs_tpu``.

The same patch-based multi-view-stereo engine, written for one NVIDIA H100:
plain tensor code is PyTorch, and the two Pallas kernels of the JAX package
(the fused photoconsistency fitness and the warped-window sampler,
``pais_mvs_tpu/ops/pallas_fitness.py``) are hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` at first use). Module names follow the JAX
package so each counterpart is easy to find. This package imports neither
JAX nor ``pais_mvs_tpu``.

Entry points take ``device=`` and default to ``"cuda"``; without a GPU they
raise unless the caller asks for ``device="cpu"`` explicitly, where every
kernel wrapper runs its plain PyTorch version.
"""

import torch as _torch

# True-f32 products everywhere (the GPU twin of pais_mvs_tpu/__init__.py's
# jax_default_matmul_precision="highest"): TF32 keeps ~3 decimal digits, and
# the TPU's silent bf16 einsum downcast degraded real-imagery seed accuracy
# 5x through the homography/projection chain (BASELINE.md round 2).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from pais_mvs_tpu_torch.config import MvsConfig, load_config_txt  # noqa: E402

__version__ = "0.1.0"


def resolve_device(device="cuda") -> _torch.device:
    """The device an entry point should use. A CUDA device without a GPU
    raises: the port never carries on silently on the CPU."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "pais_mvs_tpu_torch: CUDA requested but no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def default_device() -> _torch.device:
    """The entry points' default device (CUDA); raises without a GPU."""
    return resolve_device("cuda")


__all__ = ["MvsConfig", "load_config_txt", "default_device",
           "resolve_device", "__version__"]
