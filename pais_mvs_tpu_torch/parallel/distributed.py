"""Process-group start-up for the multi-process paths.

The counterpart of ``pais_mvs_tpu/parallel/distributed.py:21-41``
(``jax.distributed.initialize``). Every process runs the same program; the
(patch, view) layout over the ranks is ``parallel/mesh.py``; each rank
leaves with ``torch.distributed.destroy_process_group()``. A single
process needs a world of size 1 to run the view-sharded path.

    # one rank per GPU on one host (torchrun sets RANK, WORLD_SIZE,
    # LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    torchrun --nproc_per_node=4 my_script.py   # calls init_distributed()

    # the CLI's flags, as the JAX package's (every process, its own id):
    python -m pais_mvs_tpu_torch.cli -r scene.nvm --distributed-expansion \
        --coordinator host0:9876 --num-processes 4 --process-id $ID -o out$ID

Backends: NCCL when each rank has a GPU of its own; gloo for CPU tensors
and for several ranks that share one card (NCCL refuses two ranks on one
GPU). A timeout is always passed, so a rank that never arrives fails the
collective instead of blocking forever.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from pais_mvs_tpu_torch import resolve_device

DEFAULT_TIMEOUT_S = 300.0


def init_distributed(init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group and return the device this rank computes on.

    Without arguments the rank, world size and rendezvous come from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT`` through ``env://``). ``init_method`` may also be
    ``tcp://host:port`` or ``file:///path`` (a shared file store).
    ``backend`` defaults to NCCL when ``device`` is CUDA and every rank can
    have a card of its own, else gloo. On CUDA with NCCL the rank takes
    card ``LOCAL_RANK`` (default: rank modulo the card count); with gloo
    every rank uses the current card."""
    dev = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if backend is None:
        backend = ("nccl" if dev.type == "cuda"
                   and world_size <= torch.cuda.device_count() else "gloo")
    if dev.type == "cuda" and backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def init_from_flags(coordinator: Optional[str], num_processes: Optional[int],
                    process_id: Optional[int], device="cuda"
                    ) -> Optional[torch.device]:
    """The CLI's ``--coordinator host:port --num-processes N --process-id
    I`` (``pais_mvs_tpu/parallel/distributed.py:21-41``) as
    ``init_distributed("tcp://host:port", I, N)``. Returns None when no
    flag is given (one process, no group); a flag that cannot start a
    group stops with a ``SystemExit`` naming it."""
    if coordinator is None:
        for flag, value in (("--num-processes", num_processes),
                            ("--process-id", process_id)):
            if value is not None:
                raise SystemExit(f"{flag} needs --coordinator host:port")
        return None
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"--coordinator must be host:port (got "
                         f"{coordinator!r})")
    if num_processes is None or process_id is None:
        raise SystemExit("--coordinator needs --num-processes and "
                         "--process-id")
    if num_processes < 1:
        raise SystemExit(f"--num-processes must be at least 1 (got "
                         f"{num_processes})")
    if not 0 <= process_id < num_processes:
        raise SystemExit(f"--process-id {process_id} is outside [0, "
                         f"{num_processes})")
    return init_distributed(f"tcp://{coordinator}", process_id,
                            num_processes, device=device)
