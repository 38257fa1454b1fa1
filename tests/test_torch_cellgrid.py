"""PyTorch port: the cell grids (the native ``NativeCellGrids``) against
the JAX package's Python and native grids on the same arena, exact: grid
dimensions, every cell's id list in insertion order, and the same after a
removal.
"""

import numpy as np
import pytest

from pais_mvs_tpu import native as jnative
from pais_mvs_tpu.engine.arena import PatchArena as JArena
from pais_mvs_tpu.engine.cellgrid import CellGrids as JGrids
from pais_mvs_tpu_torch import native as tnative
from pais_mvs_tpu_torch.engine.arena import PatchArena as TArena

WIDTHS = [200, 180, 220, 200]
HEIGHTS = [150, 160, 140, 150]


def fake_arena(cls, n=200, C=4, seed=0):
    """tests/test_native.py's random arena, built by either package."""
    rng = np.random.default_rng(seed)
    a = cls(C)
    a.append(
        center=rng.normal(size=(n, 3)),
        normal_sph=np.stack([rng.uniform(0, np.pi, n),
                             rng.uniform(-np.pi, np.pi, n)], -1),
        cam_mask=rng.uniform(size=(n, C)) < 0.7,
        ref_cam=rng.integers(0, C, n).astype(np.int32),
        depth=rng.uniform(1, 3, n),
        lod=np.zeros(n, dtype=np.int32),
        fitness=rng.uniform(0, 2, n),
        correlation=rng.uniform(0.3, 1.0, n),
        priority=rng.permutation(n).astype(np.float64),
        color=rng.uniform(0, 255, (n, 3)),
        img_point=rng.uniform(0, 200, (n, C, 2)),
        is_seed=np.zeros(n, dtype=bool),
    )
    a.delete(np.arange(0, n, 17))
    return a


def cells_of(g):
    return {k: list(g.cell(*k)) for k in g.all_keys()}


@pytest.mark.parametrize("cell_size", [10, 14])
def test_grids_match_jax(cell_size):
    ja, ta = fake_arena(JArena), fake_arena(TArena)
    grids = {
        "jax python": JGrids.build(ja, WIDTHS, HEIGHTS, cell_size),
        "jax native": jnative.NativeCellGrids.build(ja, WIDTHS, HEIGHTS,
                                                    cell_size),
        "port native": tnative.NativeCellGrids.build(ta, WIDTHS, HEIGHTS,
                                                     cell_size),
    }
    ref = grids["jax python"]
    want = cells_of(ref)
    assert sum(len(v) for v in want.values()) > 300
    for name, g in grids.items():
        assert list(g.width) == ref.width and list(g.height) == ref.height
        assert cells_of(g) == want, name
        for pt in ((0.0, 0.0), (13.9, 27.2), (199.99, 149.5)):
            assert g.cell_of(np.asarray(pt)) == ref.cell_of(np.asarray(pt))
        assert g.in_map(1, 17, 15) == ref.in_map(1, 17, 15)
    # removals land identically
    for pid in ta.live_ids()[[5, 40, 77]]:
        for g, a in ((grids["jax python"], ja), (grids["jax native"], ja),
                     (grids["port native"], ta)):
            g.remove_patch(int(pid), a.data["cam_mask"][pid],
                           a.data["img_point"][pid])
    want = cells_of(ref)
    for name, g in grids.items():
        assert cells_of(g) == want, name
