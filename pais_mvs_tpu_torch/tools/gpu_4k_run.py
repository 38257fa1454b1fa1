"""The port's main path at 4K: the counterpart of the JAX package's
``tools/tpu_4k_run.py`` on one GPU.

Runs the complete CLI (``-r``: NVM load, PNG decode, scene build, seed
refinement, wavefront expansion, writers) on an 8-camera 4096x3072 curved
synthetic scene (amplitude 0.06, 400 seeds; r=15, PSO 15 x 30, maxLOD 8,
cellSize 16), the expansion capped at 24 rounds to bound the wall clock,
and prints one JSON line: the cloud's size and surface distance, each
stage's seconds (the scene build split into NVM load and PNG decode,
undistortion, uploads, the pyramid kernels and the rest), the refines'
rate, the autosaves, the scene's device bytes and the peak device memory
(the run's, and through the scene build), the refine graphs, and the
card's name and power limit.

    python -m pais_mvs_tpu_torch.tools.gpu_4k_run [--rounds N] [--seeds N]
        [--out DIR] [--pipeline 0|1]

``write_scene`` writes the files, ``run`` runs the CLI on them; both take
smaller sizes and the CPU for tests. The CLI's own output goes to stderr.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT, NUM_CAMS = 4096, 3072, 8
# build_scene's split in stats.json (seconds)
SPLIT = ("scene_undistort_s", "scene_upload_s", "scene_kernel_s",
         "scene_other_s")


def config_txt(pipeline: int = 0) -> str:
    """tools/tpu_4k_run.py's config.txt, line for line."""
    return ("patchRadius 15\nmaxLOD 8\nparticleNum 15\n"
            "maxIteration 30\ndistWeighting 5.0\ncellSize 16\n"
            "minCamNum 3\nseedRefineRounds 2\nbatchSize 1024\n"
            "wavefrontSize 4096\n"
            f"pipelineExpansion {pipeline}\n")


def write_scene(out_dir: str, seeds: int = 400, pipeline: int = 0,
                num_cams: int = NUM_CAMS, width: int = WIDTH,
                height: int = HEIGHT):
    """Render the curved scene and write what the CLI reads into
    ``out_dir``: one PNG per camera, ``scene.nvm`` (image points
    centre-origin) and ``config.txt``. Returns the ``SyntheticScene``,
    whose ``surface_distance`` scores the cloud."""
    from PIL import Image
    from pais_mvs_tpu_torch.data.synthetic import make_scene
    from pais_mvs_tpu_torch.io.nvm import save_nvm
    os.makedirs(out_dir, exist_ok=True)
    sc = make_scene(num_cams=num_cams, width=width, height=height,
                    num_seeds=seeds, seed=7, amplitude=0.06)
    for p, img in zip(sc.params, sc.images):
        Image.fromarray(img).save(os.path.join(out_dir, p.file_name))
    half = np.array([[[width // 2, height // 2]]], dtype=np.float64)
    save_nvm(os.path.join(out_dir, "scene.nvm"), sc.params, sc.seed_centers,
             np.full((len(sc.seed_centers), 3), 128.0), sc.seed_cam_masks,
             sc.seed_img_points - half)
    with open(os.path.join(out_dir, "config.txt"), "w") as f:
        f.write(config_txt(pipeline))
    return sc


def card_name() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def scene_bytes(scene) -> int:
    """The bytes of every tensor of a ``Scene`` (rig and atlases)."""
    return sum(getattr(part, f.name).nbytes
               for part in (scene.rig, scene.pyramids)
               for f in dataclasses.fields(part))


def run(out_dir: str, scene, rounds: int = 24, device=None,
        keep: list = None) -> dict:
    """``cli.main(["-r", "scene.nvm", "-o", out_dir])`` from ``out_dir``
    on ``device`` (the card unless the caller asks for another), with
    ``Reconstructor.expand`` capped at ``rounds`` and its autosaves timed;
    both methods are restored afterwards, also when the CLI raises.
    ``scene`` is ``write_scene``'s return. The Reconstructor the CLI ran
    is appended to ``keep`` when it is given. Returns tools/tpu_4k_run.py's
    fields and the port's own."""
    import torch
    from pais_mvs_tpu_torch import cli, resolve_device
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    from pais_mvs_tpu_torch.io import mvsbin
    dev = resolve_device("cuda" if device is None else device)
    out_dir = os.path.abspath(out_dir)
    on_card = dev.type == "cuda"
    orig_expand = Reconstructor.expand
    orig_save = Reconstructor.save_checkpoint
    orig_build = cli._build_reconstructor
    built, saves, build_peak = [], [], []

    def expand(self, max_rounds=10_000, autosave_path=None):
        return orig_expand(self, max_rounds=rounds,
                           autosave_path=autosave_path)

    def save_checkpoint(self, mvs_path):
        t0 = time.perf_counter()
        orig_save(self, mvs_path)
        saves.append(time.perf_counter() - t0)

    def build(*args, **kw):
        built.append(orig_build(*args, **kw))
        if on_card:    # the peak through the NVM load and the scene build
            build_peak.append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        return built[-1]

    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    here, buf = os.getcwd(), io.StringIO()
    Reconstructor.expand = expand
    Reconstructor.save_checkpoint = save_checkpoint
    cli._build_reconstructor = build
    try:
        os.chdir(out_dir)
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-r", "scene.nvm", "-o", out_dir,
                           "--device", str(dev)])
        if on_card:
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
    finally:
        Reconstructor.expand = orig_expand
        Reconstructor.save_checkpoint = orig_save
        cli._build_reconstructor = orig_build
        os.chdir(here)
        sys.stderr.write(buf.getvalue())
    if rc != 0:
        raise RuntimeError(f"cli -r exited {rc}")
    lines = buf.getvalue().splitlines()
    time1 = float(next(ln for ln in lines
                       if ln.startswith("time1\t")).split("\t")[1])
    rec = built[-1]
    if keep is not None:
        keep.append(rec)
    with open(os.path.join(out_dir, "stats.json")) as f:
        st = json.load(f)
    pts = mvsbin.read_mvs(os.path.join(out_dir, "exp.mvs")).patches.centers
    d = scene.surface_distance(pts)
    return {
        "scene": (f"{len(rec.params)}-cam {rec.widths[0]}x{rec.heights[0]} "
                  f"curved, seeds {len(scene.seed_centers)}"),
        "pipeline_expansion": bool(rec.cfg.pipeline_expansion),
        "rounds_cap": rounds,
        "expansion_rounds": sum(ln.startswith("round ") for ln in lines),
        "patches": int(len(pts)),
        "median_surface_dist": float(np.median(d)),
        "p95_surface_dist": float(np.quantile(d, 0.95)),
        "wall_s": wall,
        "scene_build_s": wall - time1,
        "build_scene_s": st["scene_build_s"],
        # the scene build's split: build_scene's own parts, and the NVM
        # load and PNG decode (the CLI's scene build less build_scene)
        **{k: st[k] for k in SPLIT},
        "decode_s": wall - time1 - sum(st[k] for k in SPLIT),
        "seed_s": st["seed_refine_s"],
        "seed_accepted": st["seed_accepted"],
        "expansion_s": st["expansion_s"],
        "expansion_device_s": st["expansion_device_s"],
        "expansion_host_s": st["expansion_host_s"],
        "expansion_refine_host_s": st["expansion_refine_host_s"],
        "expansion_refined": st["expansion_refined"],
        "expansion_pps": st["expansion_pps"],
        "writers_s": time1 - st["seed_refine_s"] - st["expansion_s"],
        "autosaves": len(saves),
        "autosave_s": sum(saves),
        "scene_device_bytes": scene_bytes(rec.scene),
        "atlas_shape": list(rec.scene.pyramids.images.shape),
        "peak_device_GiB": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if on_card else None),
        "peak_device_scene_build_GiB": build_peak[-1] if on_card else None,
        # the process's peak resident memory so far (Linux: KiB)
        "host_peak_rss_GiB": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
        "refine_graphs": st["refine_graphs"],
        "refine_graph_capture_s": st.get("refine_graph_capture_s"),
        "refine_graph_pool_bytes": st.get("refine_graph_pool_bytes"),
        "device": str(dev),
        "card": card_name() if on_card else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=24,
                    help="expansion wavefront round cap (bounds wall-clock)")
    ap.add_argument("--seeds", type=int, default=400)
    ap.add_argument("--out", default="/tmp/gpu_4k")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="pipelineExpansion in config.txt")
    args = ap.parse_args(argv)
    t0 = time.time()
    sc = write_scene(args.out, seeds=args.seeds, pipeline=args.pipeline)
    print(f"scene gen+write: {time.time() - t0:.1f}s", file=sys.stderr)
    print(json.dumps(run(args.out, sc, rounds=args.rounds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
