"""Process-group initialization (``torch.distributed``) and process-level
helpers (port of ``touchgs_tpu/parallel/distributed.py``).

- ``init_distributed()``: initializes the default process group once,
  from explicit arguments or the JAX package's variables
  ``COORDINATOR_ADDRESS`` (``host:port``), ``NUM_PROCESSES`` and
  ``PROCESS_ID``.  The TPU-pod variables the JAX package also reads
  (``TPU_WORKER_HOSTNAMES``, ``MEGASCALE_COORDINATOR_ADDRESS``) mean
  nothing on GPUs; torchrun's ``MASTER_ADDR`` and ``MASTER_PORT``,
  ``WORLD_SIZE`` and ``RANK`` take their role, so
  ``torchrun --nproc_per_node N script.py`` needs no argument.  The
  backend is NCCL on CUDA, and gloo only when the caller asks for the CPU.
  With nothing set it does nothing and returns False, as in the JAX
  package; an initialization that was asked for and fails raises (the JAX
  package stays single-process instead).
- ``global_mesh()``: a (data, model) mesh over every rank, with a process
  group for each of its axes.
- ``local_batch_slice()``: which items of a global work list this process
  takes (each process reads only its share of the views).

In one process every helper degrades to the single-process behaviour, so a
training script runs unchanged from one GPU to many.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from touchgs_torch.parallel.mesh import Mesh, make_mesh

INIT_TIMEOUT = datetime.timedelta(seconds=300)  # ranks that never join


def _int_env(*names) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return int(v)
    return None


def _tcp(address: str) -> str:
    """``host:port`` (or ``tcp://host:port``) as a ``tcp://`` init method;
    raises ValueError on anything else."""
    host, sep, port = address.removeprefix("tcp://").rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r}: want host:port")
    return f"tcp://{host}:{int(port)}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: torch.device | str | None = None) -> bool:
    """Initialize the default process group once.  Returns True when there
    is more than one process.

    ``device`` ``"cpu"`` takes gloo; anything else (the default) NCCL on
    the CUDA device ``LOCAL_RANK`` (else ``process_id``) modulo the cards.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    torchrun = coordinator_address is None and "MASTER_ADDR" in os.environ
    if coordinator_address is None and not torchrun:
        return False
    num_processes = num_processes or _int_env("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _int_env("PROCESS_ID", "RANK")
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator without the "
                         "number of processes and this process's id")
    init_method = "env://" if torchrun else _tcp(coordinator_address)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed wants a CUDA device for "
                               "NCCL; pass device='cpu' for gloo")
        local = _int_env("LOCAL_RANK")
        torch.cuda.set_device((process_id if local is None else local)
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend="gloo" if cpu else "nccl", init_method=init_method,
        world_size=num_processes, rank=process_id,
        timeout=INIT_TIMEOUT)
    return dist.get_world_size() > 1


def _world() -> tuple:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(model: int = 1) -> Mesh:
    """A (data, model) mesh over every rank of the world (one rank when no
    process group is initialized), with the process groups of its two
    axes (``Mesh.axis``).  Every rank calls it, in the same order
    (``make_mesh``)."""
    n = _world()[1]
    if n % model:
        raise ValueError(f"{n} ranks not divisible by model={model}")
    return make_mesh(data=n // model, model=model)


def local_batch_slice(n_items: int) -> np.ndarray:
    """Indices of the global work list this process is responsible for
    (every process sees the same global order)."""
    rank, count = _world()
    return np.arange(n_items)[rank::count]
