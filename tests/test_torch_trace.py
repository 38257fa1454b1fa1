"""PyTorch port: the job's span recorder (``pais_mvs_tpu_torch/trace.py``)
on a fake clock: spans nest, self time is the total less the children,
round ids carry to children and counters land in their round; no
``record_function`` is made while no profiler records, and the spans
reach the profiler's timeline while one does; the idle attribution of
``--profile``'s ``idle.json``."""

import pytest
import torch

from pais_mvs_tpu_torch import trace as T


class Clock:
    """A clock that moves only when told to."""

    def __init__(self):
        self.ns = 0

    def __call__(self):
        return self.ns

    def tick(self, ns):
        self.ns += ns


def test_spans_nest_with_self_time_and_rounds():
    clock = Clock()
    tr = T.Trace(clock=clock)
    with tr.span("job") as job:
        clock.tick(5)
        with tr.span("expand/round", round=3) as rnd:
            clock.tick(2)
            with tr.span("expand/prepare") as prep:
                clock.tick(7)
                tr.count("parents", 4)
            with tr.span("refine/fetch", round=2) as fetch:
                clock.tick(11)
            with tr.span("expand/insert", round=2):
                clock.tick(3)
                with tr.span("autosave"):
                    clock.tick(13)
                    tr.count("autosave_bytes", 100)
            clock.tick(1)
        clock.tick(17)
        tr.count("inserted", 9)
    assert prep.parent is rnd and rnd.parent is job and job.parent is None
    assert (prep.round, fetch.round, rnd.round, job.round) == (3, 2, 3, None)
    s = tr.summary()
    sp = s["spans"]
    assert sp["job"] == {"n": 1, "total_s": 59e-9, "self_s": 22e-9}
    assert sp["expand/round"]["total_s"] == pytest.approx(37e-9)
    assert sp["expand/round"]["self_s"] == pytest.approx(3e-9)
    assert sp["expand/insert"]["total_s"] == pytest.approx(16e-9)
    assert sp["expand/insert"]["self_s"] == pytest.approx(3e-9)
    # the root's self time plus its children's totals is the root
    kids = sum(v["total_s"] for k, v in sp.items()
               if k in ("expand/round",))
    assert sp["job"]["self_s"] + kids == pytest.approx(sp["job"]["total_s"])
    assert s["counters"] == {"parents": 4, "autosave_bytes": 100,
                             "inserted": 9}
    rows = {r["round"]: r for r in s["rounds"]}
    assert set(rows) == {2, 3}
    assert rows[3]["parents"] == 4 and rows[3]["prepare_s"] == 7e-9
    assert rows[2]["fetch_s"] == 11e-9 and rows[2]["insert_s"] == 3e-9
    assert rows[2]["autosave_s"] == 13e-9 and rows[2]["inserted"] == 0
    assert tr.total("expand/insert") == pytest.approx(16e-9)
    assert tr.seconds("refine/fetch") == [11e-9]
    assert tr.total("never") == 0.0


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not T.profiling()
    tr = T.Trace()
    with tr.span("job"):
        with tr.span("expand/round", round=1):
            pass
    assert [s.name for s in tr.spans] == ["expand/round", "job"]


def test_spans_reach_the_profilers_timeline():
    from torch.profiler import ProfilerActivity, profile
    tr = T.Trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert T.profiling()
        with tr.span("job"):
            with tr.span("expand/round", round=4):
                with tr.span("refine/stage"):
                    torch.ones(8).add_(1)
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert {"job", "expand/round round=4", "refine/stage"} <= names
    report = T.idle_report(prof, {s.name for s in tr.spans})
    assert report["job_s"] > 0
    # no device activity on the CPU: nothing to attribute
    assert report["busy_s"] is None and report["idle_by_span"] is None


def test_idle_by_span_takes_the_innermost_span_at_each_gap():
    job = (0, 100)
    spans = [(10, 60, "expand/round"), (10, 30, "refine/enqueue"),
             (40, 55, "autosave"), (70, 95, "writers")]
    busy = T.merge([(20, 25), (0, 5), (35, 45), (50, 52), (4, 8)])
    assert busy == [[0, 8], [20, 25], [35, 45], [50, 52]]
    idle = T.idle_by_span(busy, spans, job)
    # gaps: 8-20 (refine/enqueue at 14), 25-35 (expand/round at 30),
    # 45-50 and 52-100 (autosave at 47, writers at 76)
    assert idle == {"refine/enqueue": 12, "expand/round": 10,
                    "autosave": 5, "writers": 48}
    assert T.idle_by_span([], [], (0, 10)) == {T.JOB: 10}


@pytest.mark.gpu
def test_card_job_records_the_graph_steps(tmp_path, monkeypatch):
    """-r on the card (a tiny synthetic scene): the refine graphs' steps
    are spans, their counts agree with ``RefineGraphs.counts``, and the
    rounds table adds up to the expansion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured on the card")
    import json

    import numpy as np
    from PIL import Image

    from pais_mvs_tpu_torch import cli
    from pais_mvs_tpu_torch.data.synthetic import make_scene
    from pais_mvs_tpu_torch.engine.reconstructor import Reconstructor
    from pais_mvs_tpu_torch.io.nvm import save_nvm
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=12, seed=7)
    for p, img in zip(sc.params, sc.images):
        Image.fromarray(img).save(str(tmp_path / p.file_name))
    ipts = sc.seed_img_points.copy()
    ipts[..., 0] -= 80
    ipts[..., 1] -= 60
    save_nvm(str(tmp_path / "scene.nvm"), sc.params, sc.seed_centers,
             np.full((len(sc.seed_centers), 3), 128.0), sc.seed_cam_masks,
             ipts)
    (tmp_path / "config.txt").write_text(
        "patchRadius 4\nmaxLOD 3\nparticleNum 6\nmaxIteration 6\n"
        "distWeighting 1.3333\nseedRefineRounds 1\nminCamNum 3\n"
        "cellSize 14\nwavefrontSize 64\nbatchSize 64\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(Reconstructor, "autosave_interval", 40)
    assert cli.main(["-r", "scene.nvm", "-o", str(tmp_path)]) == 0
    stats = json.loads((tmp_path / "stats.json").read_text())
    sp, c = stats["trace"]["spans"], stats["trace"]["counters"]
    assert {"refine/draws", "refine/stage", "refine/replay", "refine/clone",
            "refine/first_run", "refine/capture", "refine/wait"} <= set(sp)
    assert c["graph_keys_captured"] == stats["refine_graphs"]["captured"] \
        == sp["refine/first_run"]["n"] == sp["refine/capture"]["n"] > 0
    assert c["graph_replays"] == stats["refine_graphs"]["replayed"] \
        == sp["refine/replay"]["n"] == sp["refine/stage"]["n"]
    # every K1 launch's geometry ran on the geometry kernel, replays too
    assert c["geometry_launches"] == c["fitness_launches"] > 0
    assert stats["refine_graph_capture_s"] == round(
        sp["refine/capture"]["total_s"], 3)
    rows = stats["trace"]["rounds"]
    cols = ("prepare_s", "enqueue_s", "fetch_s", "insert_s", "autosave_s")
    assert sum(r[k] for r in rows for k in cols) + \
        sp["expand/grids"]["total_s"] == pytest.approx(
            stats["expansion_s"], rel=0.03)
