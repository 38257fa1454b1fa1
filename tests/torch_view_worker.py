"""Worker processes for the port's multi-rank CPU tests
(tests/test_torch_view_fitness.py, tests/test_torch_bundle.py,
tests/test_torch_parallel_expansion.py,
tests/test_torch_engine_distributed.py).

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


def refine_stub(scene, cfg, pb, neighbor_radius, is_seed, rounds,
                final_filter=True, generator=None, draws=None, view=None):
    """A deterministic stand-in for ``lifecycle.refine_batch`` whose
    results are exact in float32 on every device and in both packages
    (tests/test_torch_parallel_expansion.py holds its jnp twin): the
    centre snapped to a 2^-8 grid (the grid absorbs last-bit differences
    of the candidate centres), a hash of its bits for the acceptance,
    correlation, fitness and priority (multiples of 2^-10), normals along
    +z (sin and cos of 0 are exact)."""
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    c = torch.round(pb.center * 256.0) / 256.0
    b = c.view(torch.int32)
    h = ((b[:, 0] * 73856093) ^ (b[:, 1] * 19349663)
         ^ (b[:, 2] * 83492791)) & 0x7FFFFFFF
    unit = lambda m: (h % m).to(torch.float32) * (1.0 / 1024.0)
    out = pb.replace(center=c, normal_sph=torch.zeros_like(pb.normal_sph),
                     correlation=unit(1021), fitness=unit(997),
                     priority=unit(1019), valid=pb.valid & (h % 7 != 0))
    return lc.RefineResult(out, torch.zeros(pb.capacity, dtype=torch.int32))


def expand_step_case(scene, cfg, inp, mesh, draws=None, stub=False,
                     refine=None):
    """``parallel.expansion.expand_step`` on this rank for the whole-round
    numpy inputs ``inp`` (occupancy whole: the rank takes its slab); the
    refine is ``refine_stub`` when ``stub``, else ``refine`` (default
    ``refine_batch``). Returns numpy: the batch
    fields as ``b_<name>``, acc, this rank's occ and ost slabs, spilled,
    sp_par, ref_cand and the rank's (patch, view) index."""
    from pais_mvs_tpu_torch.ops import lifecycle as lc
    from pais_mvs_tpu_torch.parallel import expansion as X
    k, slab = mesh.patch.index, inp["slab"]
    blk = (scene if mesh.view.size == 1
           else scene.view_block(mesh.view.index, mesh.view.size))
    orig = lc.refine_batch
    if stub:
        lc.refine_batch = refine_stub
    try:
        out = X.expand_step(
            blk, cfg, *(_t(inp[n]) for n in ("centers", "normals", "orank",
                                             "valid", "pmask")),
            _t(inp["occ"][k * slab:(k + 1) * slab]),
            _t(inp["ost"][k * slab:(k + 1) * slab]), _t(inp["cam_cells"]),
            inp["nr"], mesh, slab, inp["gh"], inp["cap"], inp["R"],
            cand_done=_t(inp["cand_done"]), draws=draws,
            generator=torch.Generator().manual_seed(0), refine=refine)
    finally:
        lc.refine_batch = orig
    pb, acc, occ, ost, spilled, sp_par, ref_cand = out
    res = {f"b_{n}": v for n, v in pb.numpy().items()}
    res.update(acc=acc.numpy(), occ=occ.numpy(), ost=ost.numpy(),
               spilled=spilled.numpy(), sp_par=sp_par.numpy(),
               ref_cand=ref_cand.numpy(),
               index=np.array([mesh.patch.index, mesh.view.index]))
    return res


def job_expand_step(rank, world, payload):
    """``expand_step_case`` once per entry of ``payload["cases"]`` (a mesh
    shape, stubbed or not, the round's draws), each on its own mesh over
    the world; results prefixed with the case's name."""
    from pais_mvs_tpu_torch.config import MvsConfig
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    scene, cfg = payload["scene"], MvsConfig(**payload["cfg"])
    out = {}
    for name, case in payload["cases"].items():
        mesh = make_mesh(case["shape"])
        got = expand_step_case(scene, cfg, payload["inputs"][case["inputs"]],
                               mesh, draws=case.get("draws"),
                               stub=case["stub"])
        out.update({f"{name}:{k}": v for k, v in got.items()})
    return out


def job_refine_dp(rank, world, payload):
    """``Reconstructor._refine_dp`` over a (world, 1) mesh with the
    injected draws, on the payload's scene and chunk."""
    from pais_mvs_tpu_torch.config import MvsConfig
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    from pais_mvs_tpu_torch.models.patch import PatchBatch
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    cfg = MvsConfig(**payload["cfg"])
    rec = Reconstructor(payload["params"], payload["images"], cfg,
                        verbose=False, device="cpu",
                        mesh=make_mesh((world, 1)))
    rec.scene = payload["scene"]
    rec.neighbor_radius = payload["nr"]
    chunk = PatchBatch(**{k: _t(v) for k, v in payload["chunk"].items()})
    res = rec._refine_dp(chunk, True, payload["rounds"],
                         draws=payload["draws"])
    out = {f"b_{k}": v for k, v in res.batch.numpy().items()}
    out.update(iterations=res.iterations.numpy(),
               chunks=np.asarray(rec._chunk_sizes(1000)),
               dp=np.array(rec._dp is not None))
    return out


def _arena_state(rec, name):
    a = rec.arena
    n = a.count
    out = {f"{name}:d_{k}": v[:n] for k, v in a.data.items()}
    out.update({f"{name}:alive": a.alive[:n].copy(),
                f"{name}:expanded": a.expanded[:n].copy(),
                f"{name}:stats": np.array([rec.stats.get(k, -1) for k in (
                    "dist_spilled", "dist_rounds", "dist_refined")])})
    return out


def job_expand_distributed(rank, world, payload):
    """``Reconstructor.expand_distributed`` on a (world, 1) mesh from one
    seed stage: the drained run, each strategy in ``payload["strategies"]``
    for two rounds, and a spilling run (small refine budget) stopped by a
    checkpoint after three rounds and resumed to the end in a fresh
    Reconstructor. Each rank returns its arenas."""
    import copy

    from pais_mvs_tpu_torch.config import MvsConfig
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    from pais_mvs_tpu_torch.parallel.mesh import make_mesh
    cfg = MvsConfig(**payload["cfg"])
    mesh = make_mesh((world, 1))
    seeds = payload["seeds"]

    def fresh(**kw):
        return Reconstructor(payload["params"], payload["images"],
                             cfg.replace(**kw), verbose=False, device="cpu",
                             mesh=mesh)

    base = fresh()
    base.load_seeds(*seeds)
    base.refine_seeds()

    def from_seeds(**kw):
        rec = fresh(**kw)
        rec.arena = copy.deepcopy(base.arena)
        rec.neighbor_radius = base.neighbor_radius
        return rec

    out = {"n_seeds": np.array(len(base.arena.live_ids()))}
    rec = from_seeds()
    rec.expand_distributed(max_rounds=64, per_shard=32)
    out.update(_arena_state(rec, "drained"))
    for s in payload["strategies"]:
        rec = from_seeds(expansion_strategy=s)
        rec.expand_distributed(max_rounds=2, per_shard=32)
        out.update(_arena_state(rec, f"strategy{s}"))
    rec = from_seeds()
    rec.expand_distributed(max_rounds=3, per_shard=32, refine_budget=8)
    ckpt = os.path.join(payload["dir"], f"rank{rank}_auto.mvs")
    rec.save_checkpoint(ckpt)
    out.update(_arena_state(rec, "stopped"))
    out["stopped_cand_done"] = np.array(sorted(rec._dist_cand_done))
    out["stopped_cand_masks"] = np.array(
        [rec._dist_cand_done[i] for i in sorted(rec._dist_cand_done)])
    res = fresh()
    assert res.load_checkpoint(ckpt)
    out["loaded_cand_done"] = np.array(sorted(res._dist_cand_done))
    out["loaded_cand_masks"] = np.array(
        [res._dist_cand_done[i] for i in sorted(res._dist_cand_done)])
    out.update(_arena_state(res, "loaded"))
    res.expand_distributed(max_rounds=61, per_shard=32, refine_budget=8)
    out.update(_arena_state(res, "resumed"))
    return out


JOBS = {"vp2": job_vp2, "vp4": job_vp4, "ba": job_ba,
        "expand_step": job_expand_step, "refine_dp": job_refine_dp,
        "expand_distributed": job_expand_distributed}

