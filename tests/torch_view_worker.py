"""Worker processes for the port's multi-rank CPU tests
(tests/test_torch_view_fitness.py, tests/test_torch_bundle.py).

This module imports only torch, numpy and the port, so that the ``spawn``
children stay free of JAX. ``run_workers`` starts ``world`` gloo ranks that
meet in a FileStore under ``tmpdir`` (never a TCP port: parallel xdist
workers cannot collide), runs one job on each, joins them with a deadline,
and kills them all on expiry, so a deadlock fails the test instead of
hanging the suite. The payload (the port's Scene, PatchBatch and PSO draws
as CPU tensors, numpy inputs) is pickled to every rank; each rank returns
a dict of numpy arrays.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np
import torch

JOIN_TIMEOUT_S = 150.0


def run_workers(job: str, world: int, tmpdir: str, payload: dict,
                timeout_s: float = JOIN_TIMEOUT_S) -> list:
    """Run ``JOBS[job](rank, world, payload)`` on ``world`` spawned ranks;
    returns their results in rank order."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(job, r, world, str(tmpdir),
                                             payload), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = []
    for r in range(world):
        path = os.path.join(tmpdir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}:\n{f.read()}")
    if alive or errs or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(
            f"{job}: ranks {alive} still running after {timeout_s:.0f} s, "
            f"exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errs))
    out = []
    for r in range(world):
        with open(os.path.join(tmpdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _main(job, rank, world, tmpdir, payload):
    torch.set_num_threads(1)
    try:
        from pais_mvs_tpu_torch.parallel.distributed import init_distributed
        init_distributed(f"file://{os.path.join(tmpdir, 'store')}", rank,
                         world, backend="gloo", device="cpu", timeout_s=120)
        out = JOBS[job](rank, world, payload)
        torch.distributed.destroy_process_group()
        with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except Exception:
        with open(os.path.join(tmpdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(payload):
    from pais_mvs_tpu_torch.config import MvsConfig
    return payload["scene"], MvsConfig(**payload["cfg"]), payload["pb"]


def _fitness(blk, cfg, payload, view):
    from pais_mvs_tpu_torch.ops import view_fitness as VF
    args = [_t(payload["problem"][k])
            for k in ("ref", "cm", "lod", "rays", "pos")]
    return {"fit": VF.fitness_view(blk, cfg, *args, view).numpy()}


def _batch_out(pb):
    return {f"out_{k}": v for k, v in pb.numpy().items()
            if k in ("valid", "center", "normal_sph", "cam_mask", "fitness",
                     "correlation", "lod", "color")}


def job_vp2(rank, world, payload):
    """(1, 2) layout: fitness, NCC vectors, the primitives, refine_batch."""
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    from pais_mvs_tpu_torch.ops import view_fitness as VF
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    scene, cfg, pb = _state(payload)
    mesh = make_mesh((1, world))
    view = mesh.view
    blk = scene.view_block(view.index, view.size)
    out = _fitness(blk, cfg, payload, view)

    # the collectives themselves: a rank-coded gather, bool included
    x = torch.full((2, 3), float(rank + 1))
    out["gather_f"] = view.all_gather(x, 1).numpy()
    out["gather_b"] = view.all_gather(torch.tensor([rank == 0, True]),
                                      0).numpy()
    # psum (a copy) and psum_ (in place) on the same rank-coded values
    y = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    out["psum_copy"] = view.psum(y).numpy()
    z = y.clone()
    got = view.psum_(z)
    out["psum_inplace"] = got.numpy().copy()
    out["psum_is_input"] = np.array(got.data_ptr() == z.data_ptr())
    out["psum_int"] = view.psum_(torch.full((3,), rank + 1,
                                            dtype=torch.int32)).numpy()

    v = payload["vectors"]
    vecs, corr, correl, ok = VF.warped_vectors_view(
        blk, cfg, _t(v["center"]), _t(v["normal"]), _t(v["ref"]),
        _t(v["cm"]), _t(v["lod"]), view)
    out.update(vecs=vecs.numpy(), corr=corr.numpy(), correl=correl.numpy(),
               ok=ok.numpy())

    res = payload["refined"]
    ref_cam = lc.set_reference_camera(scene, res.normal(), res.cam_mask)
    out["prim_lod"] = lc.set_lod(blk, cfg, res.center, ref_cam,
                                 view).numpy()
    out["prim_color"] = lc.set_image_points_and_color(
        blk, res.center, ref_cam, view)[1].numpy()
    out["prim_keep"] = lc.runtime_filter_static(blk, cfg, res, view).numpy()

    r = lc.refine_batch(blk, cfg, pb, 0.005, True, 1,
                        draws=payload["draws"], view=view)
    out.update(_batch_out(r.batch))
    return out


def job_vp4(rank, world, payload):
    """(1, 4) layout: fitness; (2, 2) layout: refine_sharded and
    sharded_pso_refine, PSO drawn from (seed, patch index)."""
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    from pais_mvs_tpu_torch.parallel.sharded import (refine_sharded,
                                                     sharded_pso_refine)
    scene, cfg, pb = _state(payload)
    m14 = make_mesh((1, world))
    m22 = make_mesh((2, world // 2))
    out = _fitness(scene.view_block(m14.view.index, m14.view.size), cfg,
                   payload, m14.view)
    blk = scene.view_block(m22.view.index, m22.view.size)
    r = refine_sharded(blk, cfg, pb, 0.005, True, 1, m22.patch, m22.view,
                       seed=payload["seed"])
    out.update(_batch_out(r.batch))
    s = payload["pso"]
    res = sharded_pso_refine(
        blk, cfg, *(_t(s[k]) for k in ("ref", "cm", "lod", "ray", "lo", "hi",
                                       "init")),
        m22.patch, m22.view, particle_num=s["P"], max_iteration=s["T"],
        seed=payload["seed"])
    out.update(pso_gbest=res.gbest.numpy(), pso_fit=res.gbest_fit.numpy(),
               pso_iters=res.iterations.numpy())
    return out


def job_ba(rank, world, payload):
    """Track-sharded bundle adjustment over every rank, once per problem
    in ``payload["problems"]`` (numpy BaProblem fields)."""
    from pais_mvs_tpu_torch.ops.bundle import BaProblem, bundle_adjust_sharded
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((world, 1))
    out = {}
    for name, fields in payload["problems"].items():
        res = bundle_adjust_sharded(BaProblem(*map(_t, fields)), mesh.patch,
                                    **payload["kw"])
        out.update({f"{name}_{k}": v.numpy()
                    for k, v in res._asdict().items()})
    return out


JOBS = {"vp2": job_vp2, "vp4": job_vp4, "ba": job_ba}

