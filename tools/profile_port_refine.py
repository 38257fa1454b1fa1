#!/usr/bin/env python3
"""Where one seed round of the PyTorch port goes on the GPU.

    python3 tools/profile_port_refine.py [--trace PATH]   # needs a CUDA GPU

Builds bench.py's workload (5 cameras at 640x480, r=15, 15 particles x 30
iterations doubled for seeds, B=1024, maxLOD 6) with ``pais_mvs_tpu_torch``,
runs one ``refine_batch`` round to warm up, then profiles one more round
with ``torch.profiler`` (CPU + CUDA activities). Prints the round's host
time, the number of device kernels it ran, the device's busy time (union
of kernel intervals) and idle share over the round's device span, and the
kernels by total device time; ``--trace`` also writes the Chrome trace.
Fails when the profiler records no device activity.
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
    args = ap.parse_args()
    sys.path.insert(0, HERE)
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

    lc.refine_batch(scene, cfg, pb, 0.005, True, 1, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lc.refine_batch(scene, cfg, pb, 0.005, True, 1, generator=gen)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3

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
    span_us = spans[-1][1] - spans[0][0]
    by_name = {}
    for s, e, name in spans:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    own = {"fitness": 0.0, "sampler": 0.0}
    for name, (t, _) in by_name.items():
        for k in own:
            if f"{k}_kernel" in name:
                own[k] += t

    print(f"card: {card}")
    print(f"one seed round, B={B}: host {host_ms:.2f} ms; device span "
          f"{span_us / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms, idle share "
          f"{1 - busy / span_us:.3f}; {len(spans)} device activities "
          f"({len(by_name)} distinct)")
    print(f"K1 fitness_kernel {own['fitness'] / 1e3:.2f} ms, K2 "
          f"sampler_kernel {own['sampler'] / 1e3:.3f} ms, all other device "
          f"work {(busy - own['fitness'] - own['sampler']) / 1e3:.2f} ms")
    print("top device activities by total time (ms, count, name):")
    for name, (t, n) in top[:15]:
        print(f"  {t / 1e3:9.3f} {n:6d}  {name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({"card": card, "host_ms": host_ms,
                      "device_span_ms": span_us / 1e3,
                      "device_busy_ms": busy / 1e3,
                      "idle_share": 1 - busy / span_us,
                      "device_activities": len(spans),
                      "k1_ms": own["fitness"] / 1e3,
                      "k2_ms": own["sampler"] / 1e3}))


if __name__ == "__main__":
    main()
