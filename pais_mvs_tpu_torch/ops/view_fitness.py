"""View-sharded photoconsistency: the fitness and NCC paths on a camera
block of the atlases, composed with collectives over the view axis.

The counterpart of ``pais_mvs_tpu/ops/view_fitness.py``: the memory-scaling
half of the (patch, view) layout (``parallel/mesh.py``). Each rank holds
one camera block of ``images``/``edges``/``var``/``rgb``
(``Scene.view_block``) and the whole rig, ``dims`` and ``yoff``. The
reference's cross-camera terms are sums or means (TMVS/mvs/patch.cpp:
914-1047), so:

  * the per-pixel mean, SAD and validity compose with ``psum`` over the
    view axis; the fitness each swarm sees equals the single-card value to
    f32 reassociation (exactly, when the view axis has size 1);
  * reference-camera lookups (foreground and edge windows) live on the
    rank owning ``ref_cam``, which writes them where the others write 0;
    a psum replicates them;
  * the NCC table pairs ALL cameras, so the locally warped window vectors
    are all-gathered before the small [C, C] table math.

Every rank makes the same collective calls in the same order: all control
flow here is static, and every value a later branch reads (fitness,
validity, NCC table) comes out of an all_reduce, which gives every rank
the same bits.

``fitness_view`` runs in two stages around the view psums, one kernel each
(``csrc/view_fitness.cu``): ``cuda_fitness.view_moments`` samples the local
block and sums, per window pixel, the valid samples and the invalid
cameras, beside the reference camera's windows on the owning rank; one
psum of those planes gives the global mean; ``cuda_fitness.view_deviation``
re-warps and sums |sample - mean| over the block; a second psum gives the
SAD; the adaptive weights stay in torch (``_weigh``). No [B, c, P, W2]
tensor of samples is made. CPU tensors run the kernels' plain twins, which
makes it, on the CPU, a mirror of the jnp reference ``fitness_view_jnp``
(view_fitness.py:98-195). It is held to that, never to
``fitness_view_pallas``. What is TPU mechanism there is not ported: the
depth sort (:240-249, :328), the depth-invariant window centre (:264-272),
the box cover (:237-238) and the rounded window centre of the reference
rows (:198-221); each particle keeps its own window centre and every
reference lookup is the per-pixel nearest one.
"""

from __future__ import annotations

import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.models.camera import PyramidSet
from pais_mvs_tpu_torch.ops import cuda_fitness as CF
from pais_mvs_tpu_torch.ops import fitness as F
from pais_mvs_tpu_torch.ops import geometry as geom
from pais_mvs_tpu_torch.ops.geometry import BIG


def block_of(scene, view):
    """(offset, c_local): the first global camera of this rank's block and
    the block's size."""
    c_local = scene.pyramids.images.shape[0]
    return view.index * c_local, c_local


def own_and_local(ref_cam, offset: int, c_local: int):
    """(own [B]: this rank holds ``ref_cam``, ref_loc [B]: its local index,
    clipped into the block so non-owners index valid memory)."""
    own = (ref_cam >= offset) & (ref_cam < offset + c_local)
    return own, torch.clamp(ref_cam - offset, 0, c_local - 1)


def _local_pyramids(pyrs, offset: int, c_local: int) -> PyramidSet:
    """The block's atlases with the block's rows of ``dims``."""
    return PyramidSet(images=pyrs.images, edges=pyrs.edges,
                      dims=pyrs.dims[offset:offset + c_local].contiguous(),
                      rgb=pyrs.rgb, var=pyrs.var, yoff=pyrs.yoff)


def _local_homographies(rig, offset: int, c_local: int, center, normal,
                        ref_cam, lod_scale):
    """Plane homographies ref -> each LOCAL camera (view_fitness.py:72-91).
    The identity is pinned on the reference camera's entry by its GLOBAL
    index, so a rank that does not hold it pins nothing. ``center`` /
    ``normal`` [..., 3]; ``ref_cam`` / ``lod_scale`` match the leading
    dims. Returns (H [..., c_local, 3, 3], hok [..., c_local])."""
    sl = slice(offset, offset + c_local)
    H, hok = geom.plane_homography(
        center[..., None, :], normal[..., None, :],
        rig.R[ref_cam][..., None, :, :], rig.T[ref_cam][..., None, :],
        rig.focal[ref_cam][..., None, :], rig.principal[ref_cam][..., None, :],
        rig.R[sl], rig.T[sl], rig.focal[sl], rig.principal[sl],
        lod_scale[..., None])
    glob = offset + torch.arange(c_local, device=H.device)
    is_ref = glob == ref_cam[..., None]
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    return torch.where(is_ref[..., None, None], eye, H), hok | is_ref


# ---------------------------------------------------------------------------
# fitness
# ---------------------------------------------------------------------------

def _fitness_geometry(scene, cfg: MvsConfig, ref_cam, cam_mask, lod, ray,
                      pos, view):
    """Per-particle geometry (view_fitness.py:105-133, :171-177).

    Returns (H [B, P, c, 3, 3] to the local cameras, pt [B, P, 2] window
    centres, pvalid [B, P]: facing, inside the reference frame, and every
    visible camera's homography well-defined on every rank)."""
    rig, pyrs = scene.rig, scene.pyramids
    B, P, _ = pos.shape
    offset, c_local = block_of(scene, view)
    normal = geom.spherical_to_normal(pos[..., :2])
    center = ray[:, None, :] * pos[..., 2:3] + rig.center[ref_cam][:, None, :]
    facing_bad = (normal * rig.optical[ref_cam][:, None, :]).sum(-1) > 0
    lod_scale = F.lod_scale_of(cfg, lod)
    H, hok = _local_homographies(rig, offset, c_local, center, normal,
                                 ref_cam[:, None].expand(B, P),
                                 lod_scale[:, None].expand(B, P))
    pt = F._project_ref(scene, center, ref_cam, lod_scale)    # [B, P, 2]
    r = cfg.patch_radius
    ref_dims = pyrs.dims[ref_cam, lod].float()                # global dims
    in_ref = ((pt[..., 0] - r >= 2) & (pt[..., 0] + r < ref_dims[:, None, 1] - 3) &
              (pt[..., 1] - r >= 2) & (pt[..., 1] + r < ref_dims[:, None, 0] - 3))
    cam_mask_loc = cam_mask[:, offset:offset + c_local]
    hbad = view.psum((~hok & cam_mask_loc[:, None, :]).sum(
        -1, dtype=torch.int32))                               # [B, P]
    return H, pt, ~facing_bad & in_ref & (hbad == 0)


def _weigh(cfg: MvsConfig, sad, bad, fg, edge, pvalid):
    """Adaptive weights and the weighted mean SAD (view_fitness.py:
    177-195); every input is replicated over the view axis."""
    cand_ok = ((bad == 0) | ~fg).all(-1) & pvalid
    weight = torch.ones_like(sad)
    if cfg.adaptive_distance_enable:
        weight = weight * F.dist_table_on(cfg.patch_radius,
                                          cfg.dist_weighting, sad.device)
    if cfg.adaptive_difference_enable:
        weight = weight * torch.exp(-sad * sad / cfg.diff_weighting)
    if cfg.adaptive_gradient_enable:
        safe_edge = torch.clamp(edge * cfg.gradient_weighting, min=1e-20)
        weight = weight * torch.exp(-1.0 / safe_edge)
    wfg = weight * fg.to(weight.dtype)
    sum_w = wfg.sum(-1)
    fit = (wfg * sad).sum(-1) / torch.where(sum_w > 0, sum_w, 1.0)
    return torch.where(cand_ok & (sum_w > 0), fit, BIG)


def fitness_view(scene, cfg: MvsConfig, ref_cam, cam_mask, lod, ray, pos,
                 view, active=None):
    """View-sharded ``ops.fitness.patch_fitness``, composed as
    ``fitness_view_jnp`` (view_fitness.py:135-195) composes it:

      1. ``view_moments`` on the local block, then ONE psum of its planes:
         the per-pixel sum of valid samples (-> mean), the count of
         invalid visible cameras, the reference intensity (-> foreground)
         and, with the gradient weight, edge weight;
      2. ``view_deviation`` against that mean, then a psum: the SAD;
      3. ``_weigh`` in torch.

    Both kernels' outputs are fresh tensors of this call, so they are
    reduced in place (``Collective.psum_``). ``scene`` holds this rank's
    camera block; ``cam_mask`` [B, C] is global. Inactive swarms come back
    BIG. Returns [B, P] f32 (BIG = rejected), the same on every view
    rank."""
    offset, c_local = block_of(scene, view)
    pyrs = _local_pyramids(scene.pyramids, offset, c_local)
    H, pt, pvalid = _fitness_geometry(scene, cfg, ref_cam, cam_mask, lod,
                                      ray, pos, view)
    cam_mask_loc = cam_mask[:, offset:offset + c_local].contiguous()
    act = cam_mask_loc if active is None else active[:, None] & cam_mask_loc
    own, ref_loc = own_and_local(ref_cam, offset, c_local)
    r = cfg.patch_radius
    grad = cfg.adaptive_gradient_enable
    mom = view.psum_(CF.view_moments(pyrs, H, pt, lod, act, cam_mask_loc,
                                     pvalid, ref_loc, own, r, grad))
    cn = cam_mask.sum(-1).to(mom.dtype)[:, None, None]
    mean = mom[0].div_(cn)                                    # [B, P, W2]
    sad = view.psum_(CF.view_deviation(pyrs, H, pt, lod, act, pvalid, mean,
                                       r)).div_(cn)
    del H
    fit = _weigh(cfg, sad, mom[1], mom[2] != 0, mom[3] if grad else None,
                 pvalid)
    if active is not None:
        fit = torch.where(active[:, None], fit, BIG)
    return fit


# ---------------------------------------------------------------------------
# NCC correlation vectors (removeInvisibleCamera's input)
# ---------------------------------------------------------------------------

def warped_vectors_view(scene, cfg: MvsConfig, center, normal, ref_cam,
                        cam_mask, lod, view):
    """View-sharded ``ops.fitness.warped_patch_vectors`` (view_fitness.py:
    369-435): each rank warps and samples its camera block with K2 in its
    NCC mode ([B, c, W2]), the blocks are all-gathered over the view axis
    (the pairwise NCC table needs every pair), and the table math runs on
    every rank. Same (vecs, corr, correlation, ok) contract."""
    rig, pyrs = scene.rig, scene.pyramids
    offset, c_local = block_of(scene, view)
    lod_scale = F.lod_scale_of(cfg, lod)
    H, hok = _local_homographies(rig, offset, c_local, center, normal,
                                 ref_cam, lod_scale)          # [B, c, 3, 3]
    pt = F._project_ref(scene, center, ref_cam, lod_scale)    # [B, 2]
    cam_mask_loc = cam_mask[:, offset:offset + c_local].contiguous()
    vals = CF.warped_samples(_local_pyramids(pyrs, offset, c_local), H, pt,
                             lod, cam_mask_loc, cfg.patch_radius)
    vok = vals > F.INVALID / 2                                # [B, c, W2]
    ok_loc = ((vok.all(-1) | ~cam_mask_loc)
              & (hok | ~cam_mask_loc)).all(-1)
    ok = view.psum((~ok_loc).to(torch.int32)) == 0
    # masked cameras' rows are INVALID, so they gather as zeros
    vecs = view.all_gather(torch.where(vok, vals, 0.0), dim=1)  # [B, C, W2]
    return F.ncc_from_vectors(vecs, cam_mask, ok)
