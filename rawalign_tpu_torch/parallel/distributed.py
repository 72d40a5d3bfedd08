"""Multi-host initialisation and scaling helpers (port of
rawalign_tpu/parallel/distributed.py).

One process per host. Each host takes its own shard of the signal files
(read-level data parallelism across hosts) and maps it with the
distributed engine over its local mesh of cards (``parallel/mesh.py``);
``torch.distributed`` joins the processes for what crosses hosts.

Usage (one process per host):

    from rawalign_tpu_torch.parallel import distributed
    distributed.init()                      # MASTER_ADDR/PORT, WORLD_SIZE, RANK
    files = distributed.shard_files(files)  # this host's input shard
    ... DistributedMappingEngine over make_mesh(...) of the local cards ...

Failure model: the index file is the unit of precomputation and mapping
restarts are read-granular through the CLI's --resume, so a failed
host's shard can be re-run on any other host against the same index and
the PAFs concatenated.
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as dist


def init(init_method: str | None = None, world_size: int | None = None,
         rank: int | None = None, *, backend: str = "nccl",
         timeout: datetime.timedelta | None = None) -> None:
    """Join the process group. ``init_method`` (``tcp://host:port``,
    ``file://path``), ``world_size`` and ``rank`` default to the
    ``env://`` rendezvous: MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK.
    The backend is NCCL unless the caller names another (``gloo`` on the
    CPU)."""
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kw,
    )


def process_info() -> tuple[int, int]:
    """(process rank, number of processes); (0, 1) when not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_files(files: list[str]) -> list[str]:
    """Deterministic round-robin assignment of input files to this host."""
    pid, n = process_info()
    return [f for i, f in enumerate(files) if i % n == pid]
