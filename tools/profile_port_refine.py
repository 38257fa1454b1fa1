#!/usr/bin/env python3
"""Where one seed round of the PyTorch port goes on the GPU.

    python3 tools/profile_port_refine.py [--view] [--trace PATH]   # GPU

Builds bench.py's workload (5 cameras at 640x480, r=15, 15 particles x 30
iterations doubled for seeds, B=1024, maxLOD 6) with ``pais_mvs_tpu_torch``,
runs one ``refine_batch`` round to warm up, times three more with CUDA
events (and their peak device memory), then profiles one more round with
``torch.profiler`` (CPU + CUDA activities). ``--view`` does so for the
view-sharded round instead (``parallel.sharded.refine_sharded`` in an
NCCL process group of world size 1, dp=1, vp=1), and also times one
``fitness_view`` evaluation on the round's first-evaluation inputs
(device time, as ``chip_smoke.py`` times kernels). Prints the profiled
round's host time, the number of device kernels it ran, the device's
busy time (union of kernel intervals) and idle share over the round's
device span, the device time of each of the port's kernels
(``<entry>_kernel`` for every entry of ``ops/cuda_fitness.ENTRIES``: on
the view round the two view kernels, ``view_moments`` and
``view_deviation``) and of all other device work, the CUDA runtime's
synchronising calls in the round (what makes the host wait), and the
kernels by total device time; ``--trace`` also writes the Chrome trace. Fails when
the profiler records no device activity.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write the Chrome trace to this file")
    ap.add_argument("--view", action="store_true",
                    help="profile the view-sharded round (world of 1)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_port_refine: needs a CUDA GPU", file=sys.stderr)
        sys.exit(2)
    from pais_mvs_tpu_torch.config import MvsConfig
    from pais_mvs_tpu_torch.data.synthetic import make_scene
    from pais_mvs_tpu_torch.models import patch as pm
    from pais_mvs_tpu_torch.models.camera import build_scene
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    from pais_mvs_tpu_torch.ops import lifecycle as lc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    B = 1024
    cfg = MvsConfig(particle_num=15, max_iteration=30, dist_weighting=5.0,
                    batch_size=B, max_lod=6)
    sc = make_scene(num_cams=5, width=640, height=480, num_seeds=B + 64,
                    seed=0)
    scene = build_scene(sc.params, sc.images, cfg, device=dev)
    rng = np.random.default_rng(0)
    centers = sc.seed_centers[:B] + rng.normal(scale=0.01, size=(B, 3))
    pb = lc.prepare_seeds(scene, cfg, pm.from_seeds(
        centers, sc.seed_cam_masks[:B], sc.seed_img_points[:B], device=dev))
    CF.build_kernels()
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.view:
        import socket
        from pais_mvs_tpu_torch.parallel.distributed import init_distributed
        from pais_mvs_tpu_torch.parallel.mesh import make_mesh
        from pais_mvs_tpu_torch.parallel.sharded import refine_sharded
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        init_distributed(f"tcp://localhost:{port}", 0, 1, backend="nccl")
        mesh = make_mesh((1, 1))
        block = scene.view_block(0, 1)
        one_round = lambda: refine_sharded(block, cfg, pb, 0.005, True, 1,
                                           mesh.patch, mesh.view, seed=0)
    else:
        one_round = lambda: lc.refine_batch(scene, cfg, pb, 0.005, True, 1,
                                            generator=gen)

    one_round()
    # the round unprofiled: CUDA events over 3 rounds, peak device memory
    round_ms, _, peak_gib, _ = chip_smoke.timed_rounds(one_round, 3)
    eval_ms = eval_host = None
    if args.view:
        # one fitness_view evaluation on the round's first-evaluation inputs
        from pais_mvs_tpu_torch.ops import view_fitness as VF
        ref, lod, ray, valid, pos = chip_smoke.first_evaluation(
            scene, cfg, pb, 2 * cfg.particle_num, gen)
        evaluate = lambda: VF.fitness_view(block, cfg, ref, pb.cam_mask,
                                           lod, ray, pos, mesh.view,
                                           active=valid)
        eval_ms, eval_host = chip_smoke.time_ms(evaluate, reps=4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    if args.view:
        torch.distributed.destroy_process_group()

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print("profile_port_refine: the profiler recorded no device "
              "activity", file=sys.stderr)
        sys.exit(1)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e, _ in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    # what blocks the host: the CUDA runtime's synchronising calls
    syncs = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and "Synchronize" in e.name:
            t, n = syncs.get(e.name, (0.0, 0))
            syncs[e.name] = (t + e.cpu_time_total, n + 1)
    span_us = spans[-1][1] - spans[0][0]
    by_name = {}
    for s, e, name in spans:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    own = dict.fromkeys(CF.ENTRIES, 0.0)
    for name, (t, _) in by_name.items():
        for k in own:
            if f"{k}_kernel" in name:
                own[k] += t

    print(f"card: {card}")
    print(f"one {'view-sharded ' if args.view else ''}seed round, B={B}: "
          f"host {host_ms:.2f} ms; device span "
          f"{span_us / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms, idle share "
          f"{1 - busy / span_us:.3f}; {len(spans)} device activities "
          f"({len(by_name)} distinct)")
    print("; ".join(f"{k}_kernel {t / 1e3:.3f} ms" for k, t in own.items()
                    if t > 0) + f"; all other device work "
          f"{(busy - sum(own.values())) / 1e3:.2f} ms")
    print(f"unprofiled round: {round_ms:.2f} ms by CUDA events (mean of "
          f"3), peak device memory {peak_gib:.3f} GiB")
    print("host waits on the device in the round (ms, count): " + (
        "; ".join(f"{n} {t / 1e3:.2f} ({c})" for n, (t, c) in
                  sorted(syncs.items(), key=lambda kv: -kv[1][0]))
        or "none"))
    if eval_ms is not None:
        print(f"one fitness_view evaluation (the round's first inputs): "
              f"{eval_ms:.4f} ms on the device, {eval_host:.4f} ms host")
    print("top device activities by total time (ms, count, name):")
    for name, (t, n) in top[:20]:
        print(f"  {t / 1e3:9.3f} {n:6d}  {name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({"card": card, "host_ms": host_ms,
                      "round_ms": round_ms, "peak_gib": peak_gib,
                      "device_span_ms": span_us / 1e3,
                      "device_busy_ms": busy / 1e3,
                      "idle_share": 1 - busy / span_us,
                      "device_activities": len(spans),
                      "kernel_ms": {k: t / 1e3 for k, t in own.items()},
                      "other_ms": (busy - sum(own.values())) / 1e3,
                      "fitness_view_eval_ms": eval_ms,
                      "fitness_view_eval_host_ms": eval_host}))


if __name__ == "__main__":
    main()
