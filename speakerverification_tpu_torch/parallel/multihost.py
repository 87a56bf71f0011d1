"""Several processes, one per GPU (port of ``parallel/multihost.py``).

The JAX package runs one process per host, each driving all of its
chips, wired by ``jax.distributed.initialize``. The port runs one
process per GPU, as the reference's DDP does (``src/trainer.py:268-299``),
wired by ``torch.distributed.init_process_group``:

* :func:`maybe_initialize_distributed` reads the rendezvous in the JAX
  package's order: the hparams keys ``coordinator_address`` /
  ``num_processes`` / ``process_id`` (``--port`` gives
  ``localhost:<port>``), then ``SVTPU_COORDINATOR`` /
  ``SVTPU_NUM_PROCESSES`` / ``SVTPU_PROCESS_ID``, then torchrun's
  ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``. A
  coordinator with a scheme (``file://...``, ``tcp://...``) is the init
  method as given, a bare ``host:port`` a TCP one. The backend is
  ``distributed_backend`` (``nccl`` by default on CUDA, ``gloo`` on the
  CPU; ``mpi`` and ``ici`` are refused by name); each CUDA process then
  takes the GPU ``LOCAL_RANK`` (else its rank modulo the visible GPUs);
* :func:`global_batch` is the rank's own batch as tensors (each rank's
  loader already holds its shard), :func:`replicate_global` a broadcast
  from rank 0 where ranks could differ;
* :func:`process_allgather` stacks every rank's array (the eval
  embeddings), in rank order.

Launch, two processes on one host:
    SVTPU_NUM_PROCESSES=2 SVTPU_PROCESS_ID=0 SVTPU_COORDINATOR=localhost:9876 \
        python -m speakerverification_tpu_torch.cli.main --do_train --distributed ...
    SVTPU_NUM_PROCESSES=2 SVTPU_PROCESS_ID=1 SVTPU_COORDINATOR=localhost:9876 \
        python -m speakerverification_tpu_torch.cli.main --do_train --distributed ...
or ``torchrun --nproc_per_node 2 -m speakerverification_tpu_torch.cli.main
--do_train --distributed ...``.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from speakerverification_tpu_torch.parallel.collectives import (
    broadcast_,
    gather_rows,
)

__all__ = ["maybe_initialize_distributed", "is_multiprocess", "is_main",
           "global_batch", "replicate_global", "process_allgather",
           "distributed_backend", "rendezvous"]

_REFUSED_BACKENDS = {
    "mpi": "PyTorch's MPI backend needs a build against MPI; use nccl or "
           "gloo",
    "ici": "ICI is the TPU's interconnect; on GPUs use nccl (or gloo)",
}


def distributed_backend(hparams: Optional[Mapping] = None,
                        cuda: Optional[bool] = None) -> str:
    """``distributed_backend`` of the config, or ``nccl`` on CUDA and
    ``gloo`` on the CPU; ``ValueError`` for ``mpi`` and ``ici``."""
    h = dict(hparams or {})
    backend = h.get("distributed_backend")
    if cuda is None:
        cuda = torch.cuda.is_available() and h.get("device") != "cpu"
    backend = str(backend or ("nccl" if cuda else "gloo"))
    if backend in _REFUSED_BACKENDS:
        raise ValueError(f"distributed_backend {backend!r} is not "
                         f"supported: {_REFUSED_BACKENDS[backend]}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"distributed_backend must be nccl or gloo, got "
                         f"{backend!r}")
    return backend


def rendezvous(hparams: Optional[Mapping] = None):
    """``(init_method, world_size, rank)`` of the configured run, or None
    when none is configured."""
    h = dict(hparams or {})
    env = os.environ
    num = h.get("num_processes", env.get("SVTPU_NUM_PROCESSES"))
    pid = h.get("process_id", env.get("SVTPU_PROCESS_ID"))
    coord = h.get("coordinator_address", env.get("SVTPU_COORDINATOR"))
    if coord is None and h.get("port"):
        coord = f"localhost:{h['port']}"
    if (num is None or pid is None) and "RANK" in env \
            and "WORLD_SIZE" in env:
        num, pid = env["WORLD_SIZE"], env["RANK"]
        if coord is None and "MASTER_ADDR" in env:
            coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
    if num is None or pid is None or coord is None:
        return None
    coord = str(coord)
    method = coord if "://" in coord else f"tcp://{coord}"
    return method, int(num), int(pid)


def maybe_initialize_distributed(hparams: Optional[Mapping] = None) -> bool:
    """Join the configured process group (once; later calls return at
    once). Returns True when more than one process runs."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    rdv = rendezvous(hparams)
    if rdv is None:
        return False
    method, world, rank = rdv
    backend = distributed_backend(hparams)
    dist.init_process_group(backend, init_method=method, world_size=world,
                            rank=rank, timeout=timedelta(minutes=30))
    if backend == "nccl" or (torch.cuda.is_available()
                             and dict(hparams or {}).get("device") != "cpu"):
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    return dist.get_world_size() > 1


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_main() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_batch(batch, mesh=None, axis: str = "data", device=None):
    """The rank's own batch as tensors on ``device``: under one process
    per GPU each rank's loader already holds its shard (the JAX function
    assembles the shards of a host's chips into one global array)."""
    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(device) if device is not None else t
    if isinstance(batch, Mapping):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def replicate_global(tensors, mesh=None):
    """Every rank's tensors set to rank 0's, in place (ranks seed their
    init identically; this makes sure). Returns ``tensors``."""
    if is_multiprocess():
        broadcast_(list(tensors), src=0)
    return tensors


def process_allgather(x) -> np.ndarray:
    """Every rank's array (the same shape on each) stacked along a new
    first axis in rank order, as numpy; a single process returns
    ``x[None]``."""
    t = (x.detach() if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(np.asarray(x))))
    if not is_multiprocess():
        return t.cpu().numpy()[None]
    t = t.cuda() if dist.get_backend() == "nccl" else t
    return gather_rows(t[None], None).cpu().numpy()
