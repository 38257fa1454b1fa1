"""The (patch, view) process layout over ``torch.distributed``.

The counterpart of ``pais_mvs_tpu/parallel/mesh.py``. There a JAX ``Mesh``
names two axes and collectives run over an axis inside ``shard_map``. Here
each process is one cell of a ``dp x vp`` grid (rank = patch index * vp +
view index), and each axis is a ``torch.distributed`` group:

  * the patch axis shards the batch of swarms (data parallel);
  * the view axis shards the per-camera mip-atlases (camera blocks, see
    ``models/camera.py::Scene.view_block``); the photoconsistency terms
    compose over it with sums (``ops/view_fitness.py``).

The view code calls collectives only through ``Collective``. A world of
size 1 is a real process group of one rank; ``world_mesh`` makes one for
a single process that has none (the CLI's and ``expand_distributed``'s
default, the counterpart of ``make_mesh((local_device_count, 1))``).
"""

from __future__ import annotations

import contextlib
import tempfile
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pais_mvs_tpu_torch.parallel.distributed import init_distributed

PATCH_AXIS = "patch"
VIEW_AXIS = "view"


class Collective:
    """Collectives over one axis of the layout: ``size`` ranks, of which
    this process is number ``index``.

    Every reduction is an ``all_reduce`` SUM, which gives every rank of the
    group the same bits. On gloo the tensors are staged through host
    memory (gloo's CUDA support differs by collective and version); NCCL
    reduces on the card. ``all_gather`` is ``all_gather_into_tensor`` on
    NCCL and gloo's list ``all_gather`` through host memory: each rank
    sends its own block once.
    """

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.size = size
        self.index = index
        self._host = dist.get_backend(group) == "gloo"

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this axis's collectives: NCCL
        runs them on the card; gloo stages them through host memory."""
        return not self._host

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the axis (a new tensor; ``x`` is untouched).
        bf16/f16 reduce in f32 and come back in their own dtype; bool is
        refused (sum an integer count instead)."""
        if x.dtype == torch.bool:
            raise TypeError("psum of a bool tensor: sum an int count")
        half = x.dtype in (torch.bfloat16, torch.float16)
        y = (x.float() if half else x).to(
            "cpu" if self._host else x.device, copy=True).contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        y = y.to(x.device)
        return y.to(x.dtype) if half else y

    def psum_(self, x: torch.Tensor) -> torch.Tensor:
        """``psum`` into ``x`` itself, for a fresh tensor the caller owns
        (its own values are overwritten): NCCL, and gloo on a host tensor,
        reduce ``x`` where it lies and save ``psum``'s copy; gloo stages a
        device tensor through host memory and copies the sum back. Returns
        ``x``."""
        if x.dtype == torch.bool:
            raise TypeError("psum of a bool tensor: sum an int count")
        if self._host and x.device.type != "cpu":
            return x.copy_(self.psum(x))
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def own_psum(self, x: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
        """psum of ``x`` masked to the owning rank (``own`` broadcastable
        bool); ``where``, not multiply, so a non-owner's garbage or NaN
        cannot leak (pais_mvs_tpu/ops/view_fitness.py:66-69)."""
        return self.psum(torch.where(own, x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device)))

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenation of every rank's ``x`` along ``dim``, in rank
        order (``jax.lax.all_gather(..., tiled=True)``). bool travels as
        uint8."""
        dim = dim % x.dim()
        is_bool = x.dtype == torch.bool
        src = (x.to(torch.uint8) if is_bool else x).movedim(dim, 0)
        if self.size == 1:
            out = src.clone()
        elif self._host:
            h = src.to("cpu").contiguous()
            parts = [torch.empty_like(h) for _ in range(self.size)]
            dist.all_gather(parts, h, group=self.group)
            out = torch.cat(parts, 0).to(x.device)
        else:
            src = src.contiguous()
            out = torch.empty((self.size * src.shape[0],) + src.shape[1:],
                              dtype=src.dtype, device=src.device)
            dist.all_gather_into_tensor(out, src, group=self.group)
        out = out.movedim(0, dim)
        return out.bool() if is_bool else out

    def all_gather_rows(self, xs: Sequence[torch.Tensor]) -> list:
        """``all_gather(x, 0)`` of every tensor in ``xs`` (equal leading
        sizes), with one collective per dtype: the tensors of a dtype
        travel side by side as the columns of one [rows, k] block."""
        n = xs[0].shape[0]
        out = [None] * len(xs)
        groups = {}
        for i, x in enumerate(xs):
            groups.setdefault(x.dtype, []).append(i)
        for dtype, idx in groups.items():
            flat = [xs[i].reshape(n, -1) for i in idx]
            g = self.all_gather(torch.cat(flat, 1), 0)
            cols = 0
            for i, f in zip(idx, flat):
                k = f.shape[1]
                out[i] = g[:, cols:cols + k].reshape(
                    (g.shape[0],) + tuple(xs[i].shape[1:]))
                cols += k
        return out


class Mesh(NamedTuple):
    """This rank's collectives over the two axes (PATCH_AXIS, VIEW_AXIS)."""

    patch: Collective
    view: Collective

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.patch.size, self.view.size)


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """Build this rank's (patch, view) groups over the initialised world.
    Default: every rank on the patch axis (atlases replicated), the right
    choice while the pyramids fit on each card. Every rank must call this
    with the same shape: ``new_group`` is collective."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    dp, vp = shape if shape is not None else (world, 1)
    if dp < 1 or vp < 1 or dp * vp != world:
        raise ValueError(f"mesh shape {(dp, vp)} does not fill the world "
                         f"of {world} ranks")
    pi, vi = divmod(rank, vp)
    patch = view = None
    for v in range(vp):
        g = dist.new_group([p * vp + v for p in range(dp)])
        if v == vi:
            patch = Collective(g, dp, pi)
    for p in range(dp):
        g = dist.new_group([p * vp + v for v in range(vp)])
        if p == pi:
            view = Collective(g, vp, vi)
    return Mesh(patch, view)


@contextlib.contextmanager
def world_mesh(device="cuda") -> Iterator[Mesh]:
    """This rank's mesh over the initialised world (``make_mesh()``: every
    rank on the patch axis), or, in a process with no process group, a
    world of one rank made for the ``with`` block and destroyed at its
    end: NCCL on a card, gloo on the CPU, meeting in a ``FileStore`` in a
    temporary directory."""
    if dist.is_initialized():
        yield make_mesh()
        return
    with tempfile.TemporaryDirectory() as d:
        init_distributed(f"file://{d}/store", 0, 1, device=device)
        try:
            yield make_mesh((1, 1))
        finally:
            dist.destroy_process_group()
