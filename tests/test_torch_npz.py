"""PyTorch port: ``io/npz.py::savez_deflated`` against ``np.savez_compressed``.

  * every dtype and shape the checkpoint sidecar holds (0-d ``count`` and
    ``neighbor_radius``, an empty ``deleted_ids``, bool masks, the
    ``[n, C, 2]`` ``img_point``, the ``cand_done_*`` pair), and members
    under one block, of exactly one, one byte over one, and of many:
    ``np.load`` gives the same arrays, each member inflates to the bytes
    ``np.save`` writes, and the blocks and raw bytes are counted;
  * the file: ``zipfile``'s CRC check passes, the members are named in
    the order given, and the deflated bytes are within 1% of
    ``savez_compressed``'s (the same where a member is one block);
  * Fortran-ordered and strided arrays as ``np.save`` keeps them, and the
    zip64 records where a size or offset needs them;
  * several threads writing at once, each file whole;
  * a worker that raises: ``save_checkpoint`` raises, and the previous
    sidecar stays as it was.
"""

import io
import os
import threading
import zipfile

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.data.synthetic import make_scene
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
from pais_mvs_tpu_torch.io import npz


def sidecar_like(n, C, seed=0):
    """The sidecar's members for an arena of ``n`` rows and ``C`` cameras
    (``engine/arena.py``'s fields), filled as a reconstruction fills them:
    a surface, smooth normals, quantised image points."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    center = np.stack([t, np.sin(7 * t), 0.1 * t ** 2], -1) \
        + 1e-3 * rng.normal(size=(n, 3))
    return dict(
        count=np.asarray(n), alive=rng.random(n) > 0.05,
        expanded=rng.random(n) > 0.3,
        deleted_ids=np.zeros(0, np.int64),
        neighbor_radius=np.asarray(0.0123),
        d_center=center, d_normal_sph=np.round(rng.random((n, 2)), 3),
        d_cam_mask=rng.random((n, C)) > 0.4,
        d_ref_cam=rng.integers(0, C, n).astype(np.int32),
        d_depth=np.linalg.norm(center, axis=1),
        d_lod=rng.integers(0, 3, n).astype(np.int32),
        d_fitness=rng.random(n), d_correlation=rng.random(n),
        d_priority=rng.random(n),
        d_color=np.round(255 * rng.random((n, 3))),
        d_img_point=np.round(640 * rng.random((n, C, 2)), 2),
        d_is_seed=rng.random(n) > 0.97,
        cand_done_ids=np.arange(0, n, 17, dtype=np.int64),
        cand_done_masks=rng.random((len(range(0, n, 17)), 16)) > 0.5)


def npy_bytes(a):
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return buf.getvalue()


def uint8_npy_of(total):
    """A uint8 array whose ``.npy`` is ``total`` bytes long."""
    k = total - (len(npy_bytes(np.zeros(total - 200, np.uint8)))
                 - (total - 200))
    a = np.random.default_rng(total).integers(0, 40, k).astype(np.uint8)
    assert len(npy_bytes(a)) == total
    return a


def write(arrays, fn=npz.savez_deflated):
    buf = io.BytesIO()
    out = fn(buf, **arrays)
    return buf.getvalue(), out


CASES = {
    "sidecar_small": sidecar_like(37, 5),
    "sidecar_many_blocks": sidecar_like(20_000, 5, seed=1),
    "sidecar_c8": sidecar_like(3_000, 8, seed=2),
    "block_edges": {
        "under": uint8_npy_of(npz.BLOCK // 3),
        "one": uint8_npy_of(npz.BLOCK),
        "one_and_a_byte": uint8_npy_of(npz.BLOCK + 1),
        "many": uint8_npy_of(5 * npz.BLOCK + 77)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loads_as_savez_compressed(case):
    arrays = CASES[case]
    ours, (raw, blocks) = write(arrays)
    ref, _ = write(arrays, np.savez_compressed)
    with np.load(io.BytesIO(ours)) as got, np.load(io.BytesIO(ref)) as want:
        assert got.files == want.files == list(arrays)
        for k in arrays:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], k)
    sizes = [len(npy_bytes(a)) for a in arrays.values()]
    assert raw == sum(sizes)
    assert blocks == sum(-(-s // npz.BLOCK) for s in sizes)
    with zipfile.ZipFile(io.BytesIO(ours)) as z:
        assert z.testzip() is None
        assert z.namelist() == [k + ".npy" for k in arrays]
        for k, a in arrays.items():
            assert z.read(k + ".npy") == npy_bytes(a), k
            assert z.getinfo(k + ".npy").compress_type == zipfile.ZIP_DEFLATED
    # the deflate streams within 1% (a member of one block is the single
    # stream itself); the file no larger by more than 1% (savez's zip64
    # extra fields make its small files the larger)
    with zipfile.ZipFile(io.BytesIO(ours)) as z, \
            zipfile.ZipFile(io.BytesIO(ref)) as zr:
        packed = [sum(i.compress_size for i in x.infolist()) for x in (z, zr)]
        for i, j in zip(z.infolist(), zr.infolist()):
            if i.file_size <= npz.BLOCK:
                assert i.compress_size == j.compress_size, i.filename
    assert abs(packed[0] - packed[1]) <= 0.01 * packed[1]
    assert len(ours) <= 1.01 * len(ref)


def test_block_edges_cut_where_stated():
    """Members of under, exactly, one byte over and several blocks are cut
    into 1, 1, 2 and 6 blocks."""
    for name, want in (("under", 1), ("one", 1), ("one_and_a_byte", 2),
                       ("many", 6)):
        _, (raw, blocks) = write({name: CASES["block_edges"][name]})
        assert blocks == want, name


def test_fortran_and_strided_arrays_as_np_save_keeps_them():
    rng = np.random.default_rng(3)
    arrays = {"fortran": np.asfortranarray(rng.random((700, 130))),
              "strided": rng.random((900, 300))[::3, ::2],
              "scalar_bool": np.asarray(True),
              "u16": rng.integers(0, 999, (41, 3, 7)).astype(np.uint16)}
    data, _ = write(arrays)
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        for k, a in arrays.items():
            assert z.read(k + ".npy") == npy_bytes(a), k
    with np.load(io.BytesIO(data)) as got:
        for k, a in arrays.items():
            np.testing.assert_array_equal(got[k], a, k)
            assert got[k].flags.f_contiguous == a.flags.f_contiguous


def test_object_arrays_are_refused():
    with pytest.raises(ValueError, match="object"):
        write({"o": np.array([{}, None], dtype=object)})


def test_zip64_records_where_sizes_need_them(monkeypatch):
    """With the zip64 threshold lowered, the members past it carry zip64
    extra fields and the end of the archive a zip64 record; ``zipfile``
    and ``np.load`` read it all."""
    monkeypatch.setattr(npz, "ZIP64_LIMIT", 4096)
    arrays = {"small": np.arange(10), **sidecar_like(2_000, 5, seed=4)}
    data, _ = write(arrays)
    assert b"PK\x06\x06" in data and b"PK\x06\x07" in data
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        assert z.testzip() is None
        for k, a in arrays.items():
            assert z.read(k + ".npy") == npy_bytes(a), k
    with np.load(io.BytesIO(data)) as got:
        for k, a in arrays.items():
            np.testing.assert_array_equal(got[k], a, k)


def test_threads_write_at_once():
    """More writers than cores at once on the one pool: every file whole."""
    n = 2 * npz.threads() + 1
    arrays = [sidecar_like(3_000 + 500 * i, 5, seed=i) for i in range(n)]
    out = [None] * n

    def run(i):
        out[i] = write(arrays[i])[0]

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    for i in range(n):
        with np.load(io.BytesIO(out[i])) as got:
            for k, a in arrays[i].items():
                np.testing.assert_array_equal(got[k], a, k)


def test_pool_width_follows_the_host():
    assert npz.threads() == min(npz.MAX_THREADS,
                                len(os.sched_getaffinity(0)))


@pytest.fixture(scope="module")
def seeded():
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=20, seed=9)
    rec = Reconstructor(sc.params, sc.images, MvsConfig(
        patch_radius=4, max_lod=3, particle_num=6, max_iteration=6,
        seed_refine_rounds=1, cell_size=10, batch_size=64,
        wavefront_size=64), verbose=False, device="cpu")
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    rec.refine_seeds()
    assert rec.arena.count > 0
    return rec


def test_save_checkpoint_writes_the_sidecar_np_load_reads(seeded, tmp_path):
    rec = seeded
    ck = str(tmp_path / "auto_save.mvs")
    rec.save_checkpoint(ck)
    a, n = rec.arena, rec.arena.count
    with np.load(ck + ".state.npz") as st:
        assert int(st["count"]) == n
        np.testing.assert_array_equal(st["alive"], a.alive[:n])
        for k, v in a.data.items():
            np.testing.assert_array_equal(st[f"d_{k}"], v[:n], k)
            assert st[f"d_{k}"].dtype == v.dtype, k
    assert not list(tmp_path.glob("*.tmp"))


def test_a_failed_worker_keeps_the_previous_sidecar(seeded, tmp_path,
                                                    monkeypatch):
    rec = seeded
    ck = str(tmp_path / "auto_save.mvs")
    rec.save_checkpoint(ck)
    before = open(ck + ".state.npz", "rb").read()
    calls = []

    def failing(parts, zdict, last):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("deflate failed")
        return real(parts, zdict, last)

    real = npz._deflate
    monkeypatch.setattr(npz, "_deflate", failing)
    rec.neighbor_radius += 1.0          # the next sidecar would differ
    try:
        with pytest.raises(RuntimeError, match="deflate failed"):
            rec.save_checkpoint(ck)
    finally:
        rec.neighbor_radius -= 1.0
    assert open(ck + ".state.npz", "rb").read() == before
    assert len(calls) >= 3
