"""PyTorch port: the refine's CUDA-graph cache (``ops/graphs.py``), the
counterpart of the JAX package's jitted ``refine_batch``, on the CPU.

A graph is captured and replayed only on the card (``gpu``-marked tests
in ``tests/test_torch_kernels.py`` and, for ``psoExitChunk > 0``, here
hold replays bit-equal to the eager refine there). Here: the draws the graphed entry takes before a replay
are the numbers ``refine_batch(generator=)`` draws inside the PSO (bit
for bit, seed and expansion mode, and over the engine's chunk plan); the
keys; the launch bookkeeping around a capture and a replay; the eager
paths, which never touch ``torch.cuda.graphs``; and the entry against
the JAX package's compiled refine with the JAX draws injected (the
lifecycle tests' bars: valid agreement >= 0.95, accepted within 2, median
centre difference <= 1e-4, since XLA fuses multiply-adds on the CPU and
torch does not).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.convert import patch_batch_from_numpy, scene_from_numpy
from pais_mvs_tpu_torch.data.synthetic import make_scene
from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
from pais_mvs_tpu_torch.models import patch as tpm
from pais_mvs_tpu_torch.models.camera import build_scene
from pais_mvs_tpu_torch.ops import graphs as G
from pais_mvs_tpu_torch.ops import lifecycle as tlc

# one intra-op thread per pytest-xdist worker, as tests/torch_parity.py
# pins it; JAX is imported inside the one test that runs it, so that the
# card, which has no JAX, runs this file's gpu-marked tests
torch.set_num_threads(1)

KW = dict(patch_radius=5, max_lod=4, particle_num=8, max_iteration=12,
          batch_size=64, dist_weighting=5.0 / 3.0)
# the chunk plan's shape: 2,500 rows over the default 1024-row ladder, a
# small swarm and window so the CPU refines it in seconds
SMALL = dict(patch_radius=2, max_lod=2, particle_num=2, max_iteration=2,
             dist_weighting=5.0 / 3.0)


@pytest.fixture(scope="module")
def port():
    """The port's own tiny scene: (scene files, Scene, prepared seeds)."""
    sc = make_scene(num_cams=5, width=200, height=150, num_seeds=40)
    rec = Reconstructor(sc.params, sc.images, MvsConfig(**KW),
                        verbose=False, device="cpu")
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points)
    return sc, rec.scene, rec._seed_pb


def _same(a, b):
    """Names of the RefineResult fields whose bits differ."""
    diff = [f.name for f in dataclasses.fields(tpm.PatchBatch)
            if not torch.equal(getattr(a.batch, f.name),
                               getattr(b.batch, f.name))]
    return diff + ([] if torch.equal(a.iterations, b.iterations)
                   else ["iterations"])


@pytest.mark.parametrize("is_seed,rounds", [
    pytest.param(True, 2, id="seed-2"),
    pytest.param(False, 1, id="expansion-1")])
def test_upfront_draws_equal_generator_path(port, is_seed, rounds):
    _, scene, pb = port
    cfg = MvsConfig(**KW)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    want = tlc.refine_batch(scene, cfg, pb, 0.005, is_seed, rounds,
                            generator=g1)
    draws = tlc.refine_draws(pb.capacity, cfg, is_seed, rounds, g2, "cpu")
    assert len(draws) == rounds
    got = tlc.refine_batch(scene, cfg, pb, 0.005, is_seed, rounds,
                           draws=draws)
    assert _same(got, want) == []
    # the generator is left where the eager refine leaves it
    assert torch.equal(g1.get_state(), g2.get_state())
    assert int(got.batch.valid.sum()) > 0.5 * pb.capacity


def test_upfront_draws_on_the_chunk_plan(port):
    """``_refine_all_async``'s chunks of a 2,500-row batch: the eager
    refine drawing from the engine's generator chunk after chunk equals
    the refine fed by ``refine_draws`` from a generator of the same
    seed."""
    sc, _, _ = port
    cfg = MvsConfig(**SMALL)
    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False,
                        device="cpu")
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points)
    B = 2500
    pb = tpm.take(rec._seed_pb, np.arange(B) % rec._seed_pb.capacity)
    sizes = rec._chunk_sizes(B)
    assert sizes == [1024, 1024, 512]
    results, _, _ = rec._refine_all_async(pb, is_seed=True, rounds=1)
    assert rec.stats["refine_graphs"] == {"captured": 0, "replayed": 0,
                                          "eager": 3}
    filler = tpm.take(pb, np.zeros(sum(sizes) - B, dtype=np.int64))
    padded = tpm.concat(pb, filler.replace(
        valid=torch.zeros_like(filler.valid)))
    gen = torch.Generator().manual_seed(cfg.rng_seed)
    s = 0
    for size, want in zip(sizes, results):
        chunk = tpm.take(padded, np.arange(s, s + size))
        s += size
        got = tlc.refine_batch(rec.scene, cfg, chunk, rec.neighbor_radius,
                               True, 1, draws=tlc.refine_draws(
                                   size, cfg, True, 1, gen, "cpu"))
        assert _same(got, want) == []
    assert torch.equal(gen.get_state(), rec.generator.get_state())


def test_keys_follow_the_ladder_and_the_config(port):
    sc, scene, _ = port
    cfg = MvsConfig(**SMALL)
    rec = Reconstructor(sc.params, sc.images, cfg.replace(batch_size=1024),
                        verbose=False, device="cpu")
    sizes = set()
    for B in range(1, 9000, 37):
        sizes.update(rec._chunk_sizes(B))
    assert sizes == {256, 512, 1024}
    keys = {G.graph_key(s, cfg, seed, 1, not seed, scene, None)
            for s in sizes for seed in (True, False)}
    assert len(keys) == 6                 # 3 ladder sizes x 2 modes
    key = G.graph_key(512, MvsConfig(**SMALL), True, 1, False, scene, None)
    assert key == G.graph_key(512, MvsConfig(**SMALL), True, 1, False,
                              scene, None)
    for change in (dict(particle_num=3), dict(max_iteration=4),
                   dict(patch_radius=3), dict(min_cam_num=2),
                   dict(dist_weighting=2.0), dict(rng_seed=1)):
        assert G.graph_key(512, cfg.replace(**change), True, 1, False,
                           scene, None) != key, change
    for other in ((256, cfg, True, 1, False, scene, None),
                  (512, cfg, False, 1, False, scene, None),
                  (512, cfg, True, 2, False, scene, None),
                  (512, cfg, True, 1, True, scene, None),
                  (512, cfg, True, 1, False, scene.to("cpu"), None),
                  (512, cfg, True, 1, False, scene, object())):
        assert G.graph_key(*other) != key


def test_launch_accounting_around_capture_and_replay():
    counts = {"fitness": 7, "sampler": 2, "view_moments": 0}

    def capture():
        counts["fitness"] += 61
        counts["sampler"] += 1

    delta = G.counted_capture(counts, capture)
    assert delta == {"fitness": 61, "sampler": 1}
    assert counts == {"fitness": 7, "sampler": 2, "view_moments": 0}
    G.add_launches(counts, delta)
    G.add_launches(counts, delta)
    assert counts == {"fitness": 129, "sampler": 4, "view_moments": 0}

    def broken():
        counts["fitness"] += 5
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        G.counted_capture(counts, broken)
    assert counts == {"fitness": 129, "sampler": 4, "view_moments": 0}


def test_eager_reasons():
    cuda = torch.device("cuda")     # a device object; nothing runs on it
    nccl = SimpleNamespace(capturable=True)
    gloo = SimpleNamespace(capturable=False)
    assert G.eager_reason(cuda, None) is None
    assert G.eager_reason(cuda, nccl) is None
    assert G.eager_reason(torch.device("cpu"), None) == G.EAGER_CPU
    # psoExitChunk > 0 is no reason: a capture runs the fixed loop
    assert G.eager_reason(cuda, gloo) == G.EAGER_GLOO


def test_cpu_reconstructor_never_touches_cuda_graphs(port, monkeypatch):
    """The seed stage and expansion on the CPU: every refine eager, each
    reason logged once, ``torch.cuda``'s graph API never reached."""
    def refuse(*a, **k):
        raise AssertionError("torch.cuda graphs touched on the CPU")

    for name in ("CUDAGraph", "graph", "graph_pool_handle"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    calls = []
    eager = tlc.refine_batch

    def counted(*a, **k):
        calls.append(a[5])                      # rounds
        return eager(*a, **k)

    monkeypatch.setattr(tlc, "refine_batch", counted)
    sc, _, _ = port
    lines = []
    rec = Reconstructor(sc.params, sc.images,
                        MvsConfig(**SMALL, seed_refine_rounds=2),
                        logger=SimpleNamespace(log=lines.append),
                        device="cpu")
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points)
    rec.refine_seeds()
    rec.expand(max_rounds=2)
    assert len(calls) >= 3
    assert rec.stats["refine_graphs"] == {"captured": 0, "replayed": 0,
                                          "eager": len(calls)}
    assert [ln for ln in lines if ln.startswith("refine runs eagerly")] == [
        f"refine runs eagerly: {G.EAGER_CPU}"]
    assert lines[-1].startswith(f"refine graphs: captured 0, replayed 0, "
                                f"eager {len(calls)};")
    assert rec.stats["refine_host_s"] > 0
    off = G.RefineGraphs(enabled=False)
    off.refine(rec.scene, rec.cfg, tpm.take(rec._seed_pb, [0]), 0.01, True,
               1, generator=torch.Generator().manual_seed(0))
    assert off.counts == {"captured": 0, "replayed": 0, "eager": 1}


def test_graphed_entry_matches_jax_compiled_refine(tiny_scene, tiny_built):
    """The graphed entry (eager on the CPU) against the JAX package's
    jitted ``refine_batch`` on the same atlas and seeds, the JAX draws
    injected, in the expansion mode every ``-r`` chunk runs (the seed
    mode's draws are held above; one JAX compile keeps the file fast)."""
    import jax
    import jax.numpy as jnp

    from pais_mvs_tpu.config import MvsConfig as JCfg
    from pais_mvs_tpu.models import patch as jpm
    from pais_mvs_tpu.ops import lifecycle as jlc
    from torch_parity import refine_draws as jax_refine_draws
    is_seed, rounds = False, 1
    jcfg, tcfg = JCfg(**KW), MvsConfig(**KW)
    jpb = jax.device_get(jlc.prepare_seeds(tiny_built, jcfg, jpm.from_seeds(
        tiny_scene.seed_centers, tiny_scene.seed_cam_masks,
        tiny_scene.seed_img_points)))
    tscene = scene_from_numpy(dataclasses.asdict(jax.device_get(tiny_built)),
                              device="cpu")
    tpb = patch_batch_from_numpy(dataclasses.asdict(jpb), device="cpu")
    key = jax.random.PRNGKey(0)
    B = tpb.capacity
    k = 2 if is_seed else 1
    jres = jlc.refine_batch(tiny_built, jcfg, jax.tree.map(jnp.asarray, jpb),
                            key, jnp.float32(0.005), is_seed, rounds)
    graphs = G.RefineGraphs()
    tres = graphs.refine(tscene, tcfg, tpb, 0.005, is_seed, rounds,
                         draws=jax_refine_draws(key, rounds, B,
                                                k * KW["particle_num"],
                                                k * KW["max_iteration"]))
    assert graphs.counts == {"captured": 0, "replayed": 0, "eager": 1}
    jv = np.asarray(jres.batch.valid)
    tv = tres.batch.valid.numpy()
    assert (jv == tv).mean() >= 0.95, (jv.sum(), tv.sum())
    assert abs(int(jv.sum()) - int(tv.sum())) <= 2
    both = jv & tv
    assert both.sum() >= 0.5 * B
    dc = np.linalg.norm(tres.batch.center.numpy()[both]
                        - np.asarray(jres.batch.center)[both], axis=-1)
    assert np.median(dc) <= 1e-4, np.median(dc)


@pytest.fixture(scope="module")
def card():
    """The tiny scene on the card, its seeds prepared, the kernels
    built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured on the card")
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    CF.build_kernels()
    sc = make_scene(num_cams=5, width=200, height=150, num_seeds=40)
    cfg = MvsConfig(**KW)
    scene = build_scene(sc.params, sc.images, cfg, device="cuda")
    pb = tlc.prepare_seeds(scene, cfg, tpm.from_seeds(
        sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
        device="cuda"))
    return scene, pb


@pytest.mark.gpu
@pytest.mark.parametrize("exit_chunk", [5, 7])
def test_exit_chunk_graph_replays_the_eager_bits(card, exit_chunk):
    """The seed round at ``psoExitChunk > 0``: the capture holds the fixed
    loop, which gives the early exit's bits. The key's first call and two
    replays at new seeds bit-equal to the eager refine with the exit and
    to the eager fixed loop; a replay launches what the fixed loop
    launches, the exit no more."""
    from pais_mvs_tpu_torch.ops import cuda_fitness as CF
    scene, pb = card
    cfg = MvsConfig(**KW, pso_exit_chunk=exit_chunk)
    graphs = G.RefineGraphs()
    gen = lambda s: torch.Generator("cuda").manual_seed(s)
    for seed in (0, 1, 2):
        launches = []
        for c in (cfg, cfg.replace(pso_exit_chunk=0)):
            CF.reset_launch_counts()
            want = tlc.refine_batch(scene, c, pb, 0.005, True, 1,
                                    generator=gen(seed))
            launches.append(dict(CF.LAUNCHES))
            if c is cfg:
                exit_res = want
        assert _same(exit_res, want) == [], seed
        CF.reset_launch_counts()
        got = graphs.refine(scene, cfg, pb, 0.005, True, 1,
                            generator=gen(seed))
        assert _same(got, want) == [], seed
        # the key's first call runs eagerly, with the exit, then captures
        assert dict(CF.LAUNCHES) == launches[0 if seed == 0 else 1], seed
        assert all(v <= launches[1][k] for k, v in launches[0].items())
    assert graphs.counts == {"captured": 1, "replayed": 2, "eager": 0}
