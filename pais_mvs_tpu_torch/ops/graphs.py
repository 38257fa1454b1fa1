"""The refine as one compiled program: ``refine_batch`` captured once per
signature as a CUDA graph and replayed.

The counterpart of ``jax.jit`` on ``pais_mvs_tpu/ops/lifecycle.py::
refine_batch`` (static ``cfg, is_seed, rounds, final_filter, view_axis``,
lifecycle.py:363), whose PSO loop runs on the device as a ``lax.scan``
(pais_mvs_tpu/ops/pso.py:253-262). Eager PyTorch enqueues every op of a
refine from Python, some 280 launches per PSO iteration; a replayed graph
enqueues the whole refine at once.

``RefineGraphs.refine`` has ``refine_batch``'s signature. Per key (the
batch's capacity, ``cfg``, ``is_seed``, ``rounds``, ``final_filter`` and
the identity of the scene or camera block and of the view collective,
``graph_key``):

  * the first call runs ``refine_batch`` eagerly (its result is the
    call's; it also builds the kernels, fills the cached device tables
    and makes the NCCL communicator's first collective), then captures
    the key's graph on static input buffers; the capture runs nothing;
  * every later call copies its inputs into those buffers (each
    ``PatchBatch`` field, ``neighbor_radius`` as a 0-dim device tensor,
    one ``PsoDraws`` per round), replays, and returns clones of the
    outputs: every graph's outputs live in one shared memory pool, which
    the next replay overwrites.

The steps are spans of the job's ``trace.Trace``: ``refine/draws``,
``refine/stage`` (the copies into the static inputs), ``refine/replay``,
``refine/clone``; a key's ``refine/first_run`` (with the wait for its
device work) and ``refine/capture``.

PSO draws come from the caller's generator before the replay, round by
round, in the order ``refine_batch(generator=)`` draws them inside
``gln_pso`` (``lifecycle.refine_draws``), so the graphed and the eager
refine run on the same numbers.

With ``psoExitChunk > 0`` the eager PSO reads a flag from the device every
chunk to stop once every swarm has frozen (the JAX package's
``lax.while_loop``, pais_mvs_tpu/ops/pso.py:230-251); under a capture
``gln_pso`` runs the fixed loop instead, which gives the same bits, so a
replay runs every iteration.

``cuda_fitness.LAUNCHES`` counts host-side launches, which under capture
are captures: the counters are restored around a capture and each replay
adds the launches its graph holds (``counted_capture``,
``add_launches``), so they go on counting what the device ran.

The eager paths are stated (``eager_reason``): CPU tensors, a view
collective on gloo, which stages through host memory. Anything else that
fails in a capture or a replay raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch

from pais_mvs_tpu_torch.config import MvsConfig
from pais_mvs_tpu_torch.models.patch import PatchBatch, _map
from pais_mvs_tpu_torch.ops import cuda_fitness as CF
from pais_mvs_tpu_torch.ops import lifecycle as lc
from pais_mvs_tpu_torch.ops.pso import PsoDraws
from pais_mvs_tpu_torch.trace import Trace

# why a refine runs eagerly
EAGER_OFF = "graphs=False (the eager arm)"
EAGER_CPU = "CPU tensors run the kernels' plain twins"
EAGER_GLOO = ("gloo collectives stage through host memory and cannot be "
              "captured")
EAGER_SINGLE = "-v --reoptimize refines one patch once"


def graph_key(B: int, cfg: MvsConfig, is_seed: bool, rounds: int,
              final_filter: bool, scene, view) -> tuple:
    """The signature a graph is captured for: what ``jax.jit`` keys
    ``refine_batch`` on (the shapes, the static arguments) and the scene
    and collective whose tensors and communicator the graph holds by
    address."""
    return (int(B), cfg, bool(is_seed), int(rounds), bool(final_filter),
            id(scene), None if view is None else id(view))


def eager_reason(device: torch.device, view) -> Optional[str]:
    """Why a refine on ``device`` with ``view`` cannot be captured, or
    None."""
    if device.type != "cuda":
        return EAGER_CPU
    if view is not None and not view.capturable:
        return EAGER_GLOO
    return None


def counted_capture(counts: Dict[str, int],
                    capture: Callable[[], None]) -> Dict[str, int]:
    """Run ``capture`` and return what it added to ``counts``, which are
    restored to their values before it, also when it raises."""
    before = dict(counts)
    try:
        capture()
    finally:
        delta = {k: v - before.get(k, 0) for k, v in counts.items()}
        counts.update(before)
    return {k: v for k, v in delta.items() if v}


def add_launches(counts: Dict[str, int], delta: Dict[str, int]) -> None:
    """Count one replay of a graph holding ``delta``'s launches."""
    for k, v in delta.items():
        counts[k] += v


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    batch: PatchBatch                 # static inputs
    neighbor_radius: torch.Tensor     # 0-dim f32
    draws: list                       # one PsoDraws per round
    out: lc.RefineResult              # static outputs
    launches: Dict[str, int]          # kernel launches per replay
    scene: object                     # held: captured by address
    view: object


class RefineGraphs:
    """A cache of ``refine_batch`` CUDA graphs, one per ``graph_key``, in
    one memory pool that lives as long as this object.

    ``counts``: refines that captured a graph (their own run is eager),
    that replayed one, and that ran eagerly on a stated path. ``log`` gets
    each eager path's reason once. ``trace`` records the steps' spans
    (``trace.seconds("refine/capture")``: each capture's seconds)."""

    def __init__(self, enabled: bool = True,
                 log: Optional[Callable[[str], None]] = None,
                 trace: Optional[Trace] = None):
        self.enabled = enabled
        self.counts = {"captured": 0, "replayed": 0, "eager": 0}
        self.trace = Trace() if trace is None else trace
        self.pool_bytes = 0             # device memory the captures reserved
        self._log = log or (lambda msg: None)
        self._reasons: set = set()
        self._graphs: dict = {}
        self._pool = None

    def summary(self) -> str:
        c = self.counts
        return (f"refine graphs: captured {c['captured']}, replayed "
                f"{c['replayed']}, eager {c['eager']}; capture "
                f"{self.trace.total('refine/capture'):.3f} s, pool "
                f"{self.pool_bytes} bytes")

    def eager(self, reason: Optional[str]) -> None:
        """Count one eager refine; log its reason (``EAGER_OFF`` when the
        cache is off) the first time."""
        if not self.enabled:
            reason = EAGER_OFF
        self.counts["eager"] += 1
        if reason not in self._reasons:
            self._reasons.add(reason)
            self._log(f"refine runs eagerly: {reason}")

    def eager_refine(self, reason: str) -> Callable:
        """``refine_batch``, counted as an eager refine for ``reason``."""
        def refine(*args, **kw):
            self.eager(reason)
            return lc.refine_batch(*args, **kw)
        return refine

    def refine(self, scene, cfg: MvsConfig, pb: PatchBatch, neighbor_radius,
               is_seed: bool, rounds: int, final_filter: bool = True,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Sequence[PsoDraws]] = None,
               view=None) -> lc.RefineResult:
        """``refine_batch``, replayed from its key's graph."""
        reason = eager_reason(pb.device, view)
        if reason is not None or not self.enabled:
            self.eager(reason)
            return lc.refine_batch(scene, cfg, pb, neighbor_radius, is_seed,
                                   rounds, final_filter, generator=generator,
                                   draws=draws, view=view)
        tr = self.trace
        if draws is None:
            with tr.span("refine/draws"):
                draws = lc.refine_draws(pb.capacity, cfg, is_seed, rounds,
                                        generator, pb.device)
        key = graph_key(pb.capacity, cfg, is_seed, rounds, final_filter,
                        scene, view)
        g = self._graphs.get(key)
        if g is None:
            with tr.span("refine/first_run"):
                res = lc.refine_batch(scene, cfg, pb, neighbor_radius,
                                      is_seed, rounds, final_filter,
                                      draws=draws, view=view)
                torch.cuda.synchronize(pb.device)
            self._graphs[key] = self._capture(scene, cfg, pb, is_seed,
                                              rounds, final_filter, draws,
                                              view)
            self.counts["captured"] += 1
            return res
        with tr.span("refine/stage"):
            for f in dataclasses.fields(PatchBatch):
                getattr(g.batch, f.name).copy_(getattr(pb, f.name))
            g.neighbor_radius.fill_(neighbor_radius)
            for static, d in zip(g.draws, draws):
                for s, t in zip(static, d):
                    s.copy_(t)
        with tr.span("refine/replay"):
            g.graph.replay()
        add_launches(CF.LAUNCHES, g.launches)
        self.counts["replayed"] += 1
        with tr.span("refine/clone"):
            return lc.RefineResult(_map(torch.clone, g.out.batch),
                                   g.out.iterations.clone())

    def _capture(self, scene, cfg, pb, is_seed, rounds, final_filter, draws,
                 view) -> _Graph:
        dev = pb.device
        batch = _map(torch.clone, pb)
        nr = torch.zeros((), dtype=torch.float32, device=dev)
        sdraws = [PsoDraws(*(t.clone() for t in d)) for d in draws]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        out = []

        def capture():
            # thread_local: the NCCL watchdog's event queries on other
            # threads do not invalidate the capture
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out.append(lc.refine_batch(scene, cfg, batch, nr, is_seed,
                                           rounds, final_filter,
                                           draws=sdraws, view=view))

        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        with self.trace.span("refine/capture"):
            launches = counted_capture(CF.LAUNCHES, capture)
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        return _Graph(graph, batch, nr, sdraws, out[0], launches, scene,
                      view)
