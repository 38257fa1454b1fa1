"""PyTorch port: the view-sharded refinement (``ops/view_fitness.py``, the
view branches of ``ops/lifecycle.py``, ``parallel/``) against the JAX
package and against the port's own single-card path, on the CPU.

The port side runs in gloo worker processes (tests/torch_view_worker.py,
two spawns: a (1, 2) world, and a world of 4 laid out as (1, 4) and as
(2, 2)); the JAX side runs here on the virtual CPU mesh, as
tests/test_view_fitness.py does. Inputs are the 4-camera ``setup4`` scene
and problem of that file (tests/test_view_fitness.py:25-53).

Tolerances, with their reasons:
  * view fitness vs JAX ``fitness_view_jnp`` under shard_map: exact BIG
    set, rtol 2e-4 / atol 1e-4 (the JAX test's own bar,
    tests/test_view_fitness.py:106): the psum order and XLA's fused
    multiply-adds move the last bits;
  * view fitness vs the port's flat fitness: exact BIG set, 1e-4: only the
    camera sum's grouping differs;
  * the view path's sampling stage (``warped_samples_view``) vs that of
    ``fitness_view_jnp``: same ok set, 1e-5 (the same f32 formulas,
    rounded alike);
  * the reference-window reads vs ``fitness_view_jnp``'s nearest lookups:
    equal (the same pixels read);
  * the view kernels' plain twins (``view_moments``, ``view_deviation``)
    vs the same quantities in jnp: counts and reference planes equal, the
    camera sums 1e-5;
  * ``Collective.psum_`` vs ``psum``: equal, and in place;
  * NCC vectors vs JAX ``warped_patch_vectors`` on visible cameras of ok
    patches: same ok set, 1e-5 (ROADMAP Queue 3: the reference keeps
    clipped-gather values in masked rows, the port zeroes them);
  * the view primitives (LOD, colour, runtime filter) vs the flat port:
    equal (one-hot routing, no floating-point reassociation);
  * refine vs the flat port on the same draws: ``valid`` agreement >= 0.95
    and median centre difference <= 1e-4 (the PSO amplifies the fitness's
    last-bit differences); the view ranks' outputs bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from pais_mvs_tpu.config import MvsConfig as JCfg
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.models.camera import build_scene as j_build
from pais_mvs_tpu.ops import fitness as JF
from pais_mvs_tpu.ops import geometry as jgeom
from pais_mvs_tpu.ops import view_fitness as JVF
from pais_mvs_tpu.parallel import mesh as jmesh
from pais_mvs_tpu_torch.config import MvsConfig as TCfg
from pais_mvs_tpu_torch.convert import scene_from_numpy
from pais_mvs_tpu_torch.models import patch as tpm
from pais_mvs_tpu_torch.models.camera import build_scene as t_build
from pais_mvs_tpu_torch.ops import fitness as TF
from pais_mvs_tpu_torch.ops import lifecycle as tlc
from pais_mvs_tpu_torch.ops import view_fitness as TVF
from pais_mvs_tpu_torch.ops.pso import draw_uniforms, gln_pso
from pais_mvs_tpu_torch.parallel.sharded import patch_seed
import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_view_worker import run_workers

KW = dict(patch_radius=5, max_lod=4, particle_num=8, max_iteration=12,
          batch_size=64, dist_weighting=5.0 / 3.0)
B_FIT, P_FIT = 8, 9
B_REF = 16
SEED = 11
PSO = dict(P=6, T=8)


@pytest.fixture(scope="module")
def setup4():
    """tests/test_view_fitness.py's 4-camera scene, in both packages (the
    same atlas bits) and its fitness problem (:36-53)."""
    sc = make_scene(num_cams=4, width=200, height=150, num_seeds=40)
    jscene = j_build(sc.params, sc.images, JCfg(**KW))
    tscene = scene_from_numpy(dataclasses.asdict(jax.device_get(jscene)),
                              device="cpu")
    B = B_FIT
    centers = sc.seed_centers[:B].astype(np.float32)
    ref = np.full(B, 2, dtype=np.int32)
    rays = centers - np.asarray(jscene.rig.center)[ref]
    depths = np.linalg.norm(rays, axis=-1)
    rays = (rays / depths[:, None]).astype(np.float32)
    sph = np.asarray(jgeom.normal_to_spherical(jnp.asarray(sc.plane_normal)))
    rng = np.random.default_rng(0)
    pos = np.stack([
        sph[0] + rng.normal(scale=0.25, size=(B, P_FIT)),
        sph[1] + rng.normal(scale=0.35, size=(B, P_FIT)),
        depths[:, None] + rng.uniform(-0.05, 0.05, size=(B, P_FIT)),
    ], -1).astype(np.float32)
    problem = dict(ref=ref, cm=np.ones((B, 4), bool),
                   lod=np.zeros(B, np.int32), rays=rays, pos=pos)
    return sc, jscene, tscene, problem


def _flat_inputs(problem):
    return [torch.from_numpy(problem[k])
            for k in ("ref", "cm", "lod", "rays", "pos")]


@pytest.fixture(scope="module")
def batches(setup4):
    """A prepared seed batch, a refined batch (for the primitives), PSO
    draws, and the NCC-vector problem (seeds off the surface too)."""
    sc, _, tscene, _ = setup4
    cfg = TCfg(**KW)
    pb = tlc.prepare_seeds(tscene, cfg, tpm.from_seeds(
        sc.seed_centers[:B_REF], sc.seed_cam_masks[:B_REF],
        sc.seed_img_points[:B_REF], device="cpu"))
    refined = tlc.refine_batch(tscene, cfg, pb, 0.005, True, 1,
                               generator=torch.Generator().manual_seed(4))
    P, T = 2 * cfg.particle_num, 2 * cfg.max_iteration
    draws = draw_uniforms(B_REF, P, 3, T,
                          generator=torch.Generator().manual_seed(5),
                          device="cpu")
    normal = pb.normal()
    ref = tlc.set_reference_camera(tscene, normal, pb.cam_mask)
    lod = tlc.set_lod(tscene, cfg, pb.center, ref)
    center = pb.center.clone()
    center[::3] += 0.3                         # some windows leave frame
    vectors = dict(center=center.numpy(), normal=normal.numpy(),
                   ref=ref.numpy(), cm=pb.cam_mask.numpy(), lod=lod.numpy())
    return pb, refined.batch, draws, vectors


def _pso_problem(tscene, cfg, pb):
    """PSO inputs of the first refine round for sharded_pso_refine."""
    normal = pb.normal()
    ref = tlc.set_reference_camera(tscene, normal, pb.cam_mask)
    depth, ray = tlc.set_depth_and_ray(tscene, pb.center, ref)
    dr, _ = tlc.set_depth_range(tscene, cfg, pb.center, ray, depth, ref,
                                pb.cam_mask, torch.tensor(0.005))
    lod = tlc.set_lod(tscene, cfg, pb.center, ref)
    sph = pb.normal_sph
    lo = torch.stack([torch.zeros(B_REF), sph[:, 1] - np.pi / 2, dr[:, 0]],
                     -1)
    hi = torch.stack([torch.full((B_REF,), np.pi), sph[:, 1] + np.pi / 2,
                      dr[:, 1]], -1)
    init = torch.stack([sph[:, 0], sph[:, 1], depth], -1)
    return dict(ref=ref, cm=pb.cam_mask, lod=lod, ray=ray, lo=lo, hi=hi,
                init=init)


def _payload(setup4, batches):
    _, _, tscene, problem = setup4
    pb, refined, draws, vectors = batches
    cfg = TCfg(**KW)
    return dict(scene=tscene, cfg=KW, pb=pb, problem=problem,
                refined=refined, draws=[draws], vectors=vectors, seed=SEED,
                pso={**PSO, **{k: v.numpy() for k, v in _pso_problem(
                    tscene, cfg, pb).items()}})


@pytest.fixture(scope="module")
def vp2(setup4, batches, tmp_path_factory):
    return run_workers("vp2", 2, tmp_path_factory.mktemp("vp2"),
                       _payload(setup4, batches))


@pytest.fixture(scope="module")
def vp4(setup4, batches, tmp_path_factory):
    return run_workers("vp4", 4, tmp_path_factory.mktemp("vp4"),
                       _payload(setup4, batches))


def _jax_fitness_view(jscene, problem, vp):
    """fitness_view_jnp under shard_map on a (2, vp) mesh
    (tests/test_view_fitness.py:56-74)."""
    cfg = JCfg(**KW)
    c_local = 4 // vp
    mesh = jmesh.make_mesh((2, vp), jax.devices()[:2 * vp])
    rig_spec = jax.tree.map(lambda _: PS(), jscene.rig)

    def body(rig, img, edg, dims, yo, ref_c, cmk, ld, ry, ps):
        return JVF.fitness_view_jnp(rig, img, edg, dims, yo, cfg, c_local,
                                    ref_c, cmk, ld, ry, ps, "view")

    f = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(rig_spec, PS("view"), PS("view"), PS(), PS(),
                  PS("patch"), PS("patch"), PS("patch"), PS("patch"),
                  PS("patch")),
        out_specs=PS("patch"), check_vma=False))
    p = problem
    return np.asarray(f(jscene.rig, jscene.pyramids.images,
                        jscene.pyramids.edges, jscene.pyramids.dims,
                        jscene.pyramids.yoff, *(jnp.asarray(p[k]) for k in (
                            "ref", "cm", "lod", "rays", "pos"))))


def _ranks_equal(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key], err_msg=key)
    return outs[0][key]


@pytest.mark.parametrize("vp", [2, 4])
@pytest.mark.parametrize("against", ["jax", "flat"])
def test_fitness_view_matches_jax_and_flat(setup4, vp2, vp4, vp, against):
    _, jscene, tscene, problem = setup4
    got = _ranks_equal(vp2 if vp == 2 else vp4, "fit")
    big = got >= 1e20
    assert (~big).sum() > 20
    if against == "jax":
        want = _jax_fitness_view(jscene, problem, vp)
        tol = dict(rtol=2e-4, atol=1e-4)
    else:
        want = TF.patch_fitness(tscene, TCfg(**KW),
                                *_flat_inputs(problem)).numpy()
        tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(big, want >= 1e20)
    np.testing.assert_allclose(got[~big], want[~big], **tol)


def _jax_samples(jscene, H, pt, lod, radius, cams):
    """The sampling stage of fitness_view_jnp (pais_mvs_tpu/ops/
    view_fitness.py:145-160), written out with the JAX package's own
    bilinear_gather on the cameras ``cams`` (a slice of the rig), at the
    port's H [B, P, c, 3, 3] and window centres pt [B, P, 2]. Returns
    (vals, vok) [B, P, W2, c] as numpy; vok holds the bounds and w != 0
    only (no act or pvalid)."""
    pyr = jscene.pyramids
    offs = jnp.asarray(JF.window_offsets(radius))
    win = jnp.asarray(pt.numpy())[:, :, None, :] + offs[None, None]
    x, y = win[..., 0][..., None], win[..., 1][..., None]
    Hc = jnp.asarray(H.numpy())[:, :, None]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = jnp.where(w == 0, 1.0, w)
    u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    B, P, W2, C = w.shape
    vals, vok = JF.bilinear_gather(
        pyr.images[cams], pyr.yoff,
        jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (B, P, W2, C)),
        jnp.broadcast_to(jnp.asarray(np.asarray(lod))[:, None, None, None],
                         (B, P, W2, C)),
        jnp.stack([u, v], -1), pyr.dims[cams], 2.0, 3.0)
    return np.asarray(vals), np.asarray(vok & (w != 0))


def _jax_ref_windows(jscene, pt, ref_loc, own, lod, radius, cams):
    """fitness_view_jnp's reference lookups (pais_mvs_tpu/ops/
    view_fitness.py:135-143, :185-187): the JAX package's nearest_gather at
    round(pt + offset) on the block ``cams`` of the intensity and edge
    atlases, kept on the owning rank as own_psum's ``where`` keeps them.
    Returns [2, B, P, W2] f32 as numpy."""
    win = (jnp.asarray(pt.numpy())[:, :, None, :]
           + jnp.asarray(JF.window_offsets(radius))[None, None])
    B, P, W2 = win.shape[:3]
    bc = lambda a: jnp.broadcast_to(jnp.asarray(a)[:, None, None],
                                    (B, P, W2))
    pyr = jscene.pyramids
    return np.stack([np.where(own[:, None, None], np.asarray(
        JF.nearest_gather(atlas[cams], pyr.yoff, bc(ref_loc), bc(lod), win),
        np.float32), 0.0) for atlas in (pyr.images, pyr.edges)])


def test_sampler_view_twin_matches_jax_stage(setup4):
    """The view path's sampling stage (the plain ``warped_samples_view``
    that the view kernels' twins build on) against the sampling stage of
    fitness_view_jnp, on the same H and window centres; with act and
    pvalid switching rows off."""
    _, jscene, tscene, problem = setup4
    cfg = TCfg(**KW)
    ref, cm, lod, rays, pos = _flat_inputs(problem)
    H, pt, pvalid = TF.fitness_geometry(tscene, cfg, ref, cm, lod, rays, pos)
    act = cm.clone()
    act[::3, 1] = False
    got = TF.warped_samples_view(tscene.pyramids, H, pt, lod, act, pvalid,
                                 cfg.patch_radius).numpy()  # [B, C, P, W2]
    vals, vok = _jax_samples(jscene, H, pt, lod, cfg.patch_radius,
                             slice(None))
    vok = (vok & act.numpy()[:, None, None, :]
           & pvalid.numpy()[:, :, None, None]).transpose(0, 3, 1, 2)
    vals = vals.transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got > TF.INVALID / 2, vok)
    assert 0.2 < vok.mean() < 1.0
    np.testing.assert_allclose(got[vok], vals[vok], rtol=1e-5, atol=1e-5)


def test_reference_windows_twin_matches_jax(setup4):
    """The reference-window reads against fitness_view_jnp's own lookups
    on the camera block {2, 3}, with reference cameras on and off the
    block: equal (the same lookups)."""
    _, jscene, tscene, problem = setup4
    cfg = TCfg(**KW)
    r = cfg.patch_radius
    _, pt, _ = TF.fitness_geometry(tscene, cfg, *_flat_inputs(problem))
    B = pt.shape[0]
    ref = np.arange(B, dtype=np.int32) % 4
    own = (ref >= 2) & (ref < 4)
    ref_loc = np.clip(ref - 2, 0, 1).astype(np.int32)
    lod = problem["lod"]
    got = TF.reference_windows(tscene.view_block(1, 2).pyramids, pt,
                               torch.from_numpy(ref_loc),
                               torch.from_numpy(own), torch.from_numpy(lod),
                               r, True).numpy()           # [2, B, P, W2]
    want = _jax_ref_windows(jscene, pt, ref_loc, own, lod, r, slice(2, 4))
    np.testing.assert_array_equal(got, want)
    assert 0.2 < (got[0] != 0).mean() < 0.9
    assert (got[1][own] != 0).any()


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("case", ["act", "pvalid", "own"])
def test_view_kernel_twins_match_jax(setup4, case, grad):
    """The plain twins of the view fitness's two kernels, ``view_moments``
    and ``view_deviation``, on the camera block {2, 3}, against the
    quantities fitness_view_jnp computes from the same sampling stage
    (pais_mvs_tpu/ops/view_fitness.py:135-172): the valid samples' sum and
    the invalid visible cameras per pixel, the reference windows, and the
    deviation from a given mean. Cases: act rows off (a camera of some
    patches, every camera of inactive swarms), pvalid rows off, reference
    cameras on and off the block; with and without the edge plane.
    Planes 1-3 equal; plane 0 and the deviation to 1e-5 (relative above
    1): the same f32 formulas, summed over two cameras."""
    _, jscene, tscene, problem = setup4
    cfg = TCfg(**KW)
    r = cfg.patch_radius
    ref, cm, lod, rays, pos = _flat_inputs(problem)
    H, pt, pvalid = TF.fitness_geometry(tscene, cfg, ref, cm, lod, rays, pos)
    B = pt.shape[0]
    cams = slice(2, 4)
    pyrs = TVF._local_pyramids(tscene.view_block(1, 2).pyramids, 2, 2)
    Hb = H[:, :, cams].contiguous()
    mask = cm[:, cams].contiguous()
    act = mask.clone()
    ref_glob = ref.numpy()
    if case == "act":
        act[::3, 0] = False
        act[1::3] = False
    elif case == "pvalid":
        pvalid = pvalid.clone()
        pvalid[:, ::2] = False
        pvalid[3] = False
    else:
        ref_glob = np.arange(B, dtype=np.int32) % 4
    own = (ref_glob >= 2) & (ref_glob < 4)
    ref_loc = np.clip(ref_glob - 2, 0, 1).astype(np.int32)
    got = TF.view_moments(pyrs, Hb, pt, lod, act, mask, pvalid,
                          torch.from_numpy(ref_loc), torch.from_numpy(own),
                          r, grad).numpy()
    assert got.shape == (4 if grad else 3, B, P_FIT, (2 * r + 1) ** 2)

    vals, vok = _jax_samples(jscene, Hb, pt, lod, r, cams)   # [B,P,W2,c]
    ok = (vok & act.numpy()[:, None, None, :]
          & pvalid.numpy()[:, :, None, None])
    assert ok.mean() > 0.1
    total = np.where(ok, vals, 0.0).sum(-1)
    bad = (mask.numpy()[:, None, None, :] & ~ok).sum(-1).astype(np.float32)
    refw = _jax_ref_windows(jscene, pt, ref_loc, own, lod.numpy(), r, cams)
    np.testing.assert_allclose(got[0], total, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], bad)
    np.testing.assert_array_equal(got[2:], refw[:2 if grad else 1])
    assert (bad == 0).any()
    if case != "own":
        assert (bad > 0).any()
    else:
        assert own.any() and not own.all()
        assert not got[2][~own].any() and got[2][own].any()

    mean = total.astype(np.float32) / np.float32(4.0)
    dev = TF.view_deviation(pyrs, Hb, pt, lod, act, pvalid,
                            torch.from_numpy(mean), r).numpy()
    want = np.where(ok, np.abs(vals - mean[..., None]), 0.0).sum(-1)
    np.testing.assert_allclose(dev, want, rtol=1e-5, atol=1e-5)
    assert not dev[~ok.any(-1)].any()


def test_warped_vectors_view_matches_jax(setup4, batches, vp2):
    _, jscene, _, _ = setup4
    v = batches[3]
    va, ca, corra, oka = (np.asarray(a) for a in JF.warped_patch_vectors(
        jscene, JCfg(**KW), *(jnp.asarray(v[k]) for k in (
            "center", "normal", "ref", "cm", "lod"))))
    ok = _ranks_equal(vp2, "ok")
    np.testing.assert_array_equal(ok, oka)
    assert 0 < ok.sum() < len(ok)
    vis = ok[:, None] & v["cm"]
    np.testing.assert_allclose(_ranks_equal(vp2, "vecs")[vis], va[vis],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_ranks_equal(vp2, "corr")[ok], ca[ok],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_ranks_equal(vp2, "correl")[ok], corra[ok],
                               rtol=1e-5, atol=1e-5)


def test_view_collectives(vp2):
    np.testing.assert_array_equal(
        _ranks_equal(vp2, "gather_f"),
        np.concatenate([np.full((2, 3), 1.0), np.full((2, 3), 2.0)], 1))
    np.testing.assert_array_equal(_ranks_equal(vp2, "gather_b"),
                                  [True, True, False, True])


def test_psum_in_place_matches_psum(vp2):
    """``Collective.psum_`` reduces the caller's tensor itself (gloo on a
    host tensor) and gives the values ``psum`` gives."""
    want = np.arange(6, dtype=np.float32).reshape(2, 3) * 3
    np.testing.assert_array_equal(_ranks_equal(vp2, "psum_copy"), want)
    np.testing.assert_array_equal(_ranks_equal(vp2, "psum_inplace"), want)
    assert _ranks_equal(vp2, "psum_is_input")
    np.testing.assert_array_equal(_ranks_equal(vp2, "psum_int"), [3, 3, 3])


def test_view_primitives_match_flat(setup4, batches, vp2):
    _, _, tscene, _ = setup4
    cfg = TCfg(**KW)
    res = batches[1]
    ref = tlc.set_reference_camera(tscene, res.normal(), res.cam_mask)
    np.testing.assert_array_equal(
        _ranks_equal(vp2, "prim_lod"),
        tlc.set_lod(tscene, cfg, res.center, ref).numpy())
    np.testing.assert_array_equal(
        _ranks_equal(vp2, "prim_color"),
        tlc.set_image_points_and_color(tscene, res.center, ref)[1].numpy())
    keep = _ranks_equal(vp2, "prim_keep")
    np.testing.assert_array_equal(
        keep, tlc.runtime_filter_static(tscene, cfg, res).numpy())
    assert 0 < keep.sum()


def _agree(outs, flat):
    """The batch every rank returned (bit-equal across ranks) against the
    flat port's."""
    valid = _ranks_equal(outs, "out_valid")
    for k in ("out_center", "out_normal_sph", "out_cam_mask", "out_fitness",
              "out_correlation", "out_lod", "out_color"):
        _ranks_equal(outs, k)
    fv = flat.valid.numpy()
    assert (valid == fv).mean() >= 0.95, (valid.sum(), fv.sum())
    both = valid & fv
    assert both.sum() >= 0.5 * len(fv)
    dc = np.linalg.norm(outs[0]["out_center"][both]
                        - flat.center.numpy()[both], axis=-1)
    assert np.median(dc) <= 1e-4, np.median(dc)


def test_refine_batch_view_matches_flat(setup4, batches, vp2):
    """refine_batch(view=...) at vp=2 with injected draws, against the flat
    port on the same draws; both view ranks return the same bits."""
    _, _, tscene, _ = setup4
    pb, _, draws, _ = batches
    flat = tlc.refine_batch(tscene, TCfg(**KW), pb, 0.005, True, 1,
                            draws=[draws]).batch
    _agree(vp2, flat)


def test_refine_sharded_matches_flat(setup4, batches, vp4):
    """refine_sharded on a (2, 2) layout: each patch slice draws from
    (seed, patch index) and never from the view index, so the flat port
    refining each slice from the same generator is its yardstick; all four
    ranks return the same gathered batch."""
    _, _, tscene, _ = setup4
    pb = batches[0]
    cfg = TCfg(**KW)
    n = B_REF // 2
    parts = [tlc.refine_batch(
        tscene, cfg, tpm.take(pb, np.arange(p * n, (p + 1) * n)), 0.005,
        True, 1, generator=torch.Generator().manual_seed(patch_seed(SEED, p))
        ).batch for p in range(2)]
    _agree(vp4, tpm.concat(*parts))


def test_sharded_pso_refine_matches_flat(setup4, batches, vp4):
    _, _, tscene, _ = setup4
    cfg = TCfg(**KW)
    s = _pso_problem(tscene, cfg, batches[0])
    n = B_REF // 2
    fit, gbest = [], []
    for p in range(2):
        sl = slice(p * n, (p + 1) * n)
        fn = (lambda pos, act, sl=sl: TF.patch_fitness(
            tscene, cfg, s["ref"][sl], s["cm"][sl], s["lod"][sl],
            s["ray"][sl], pos))
        r = gln_pso(fn, s["lo"][sl], s["hi"][sl], s["init"][sl],
                    particle_num=PSO["P"], max_iteration=PSO["T"],
                    generator=torch.Generator().manual_seed(
                        patch_seed(SEED, p)))
        fit.append(r.gbest_fit.numpy())
        gbest.append(r.gbest.numpy())
    got_fit = _ranks_equal(vp4, "pso_fit")
    _ranks_equal(vp4, "pso_gbest")
    np.testing.assert_allclose(got_fit, np.concatenate(fit), rtol=1e-4,
                               atol=1e-4)
    dg = np.abs(vp4[0]["pso_gbest"] - np.concatenate(gbest)).max(-1)
    assert np.median(dg) <= 1e-4, np.median(dg)


def test_view_block_scene(setup4):
    """build_scene(view_block=...) cuts the atlases on the host into the
    same block Scene.view_block cuts on the device, keeps the rig, dims and
    yoff whole, and refuses a view axis that does not divide C."""
    sc, _, _, _ = setup4
    cfg = TCfg(**KW)
    full = t_build(sc.params, sc.images, cfg, device="cpu")
    blk = t_build(sc.params, sc.images, cfg, device="cpu",
                  view_block=(1, 2))
    ref = full.view_block(1, 2)
    for part in ("rig", "pyramids"):
        a, b = getattr(blk, part), getattr(ref, part)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert blk.pyramids.images.shape[0] == 2
    assert torch.equal(blk.pyramids.images, full.pyramids.images[2:4])
    assert blk.num_cameras == 4
    with pytest.raises(ValueError, match="must divide the camera count 4"):
        full.view_block(0, 3)
    with pytest.raises(ValueError, match="must divide the camera count 4"):
        t_build(sc.params, sc.images, cfg, device="cpu", view_block=(0, 3))


def test_init_distributed_defaults_to_the_card(tmp_path):
    """The process-group entry point computes on the card unless the
    caller asks for the CPU: without a GPU it raises before joining."""
    from pais_mvs_tpu_torch.parallel.distributed import init_distributed
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        init_distributed(f"file://{tmp_path / 'store'}", 0, 1)
    assert not torch.distributed.is_initialized()
