"""Multi-process start-up and the split of an evaluation sequence.

Counterpart of ``obvi_slam_tpu/parallel/distributed.py``:

  - ``initialize()`` starts ``torch.distributed`` from its arguments or the
    reference's environment variables (``COORDINATOR_ADDRESS`` host:port,
    ``NUM_PROCESSES``, ``PROCESS_ID``), so that one CLI runs single-process
    (nothing set: a no-op) and under a launcher that sets them; NCCL when
    the rank computes on CUDA, gloo on the CPU;
  - ``global_mesh()`` is the mesh over every rank;
  - ``shard_sessions`` splits a sequence's independent session chains
    round-robin over processes (sessions that chain long-term maps share a
    "chain" key and stay on one process).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

# How long a rank waits in a collective for the others before it fails.
TIMEOUT_S = 600


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> bool:
    """Initializes the default process group from the arguments or the
    environment; False (and nothing done) when no coordinator is given.
    ``device`` "cpu" takes gloo; otherwise NCCL when CUDA is available,
    with rank r on CUDA device r modulo the device count."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", "0"))
    on_cuda = device != "cpu" and torch.cuda.is_available()
    if on_cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if on_cuda else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return True


def global_mesh(device=None):
    """The mesh over every rank of the default process group."""
    from obvi_slam_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(device=device)


def shard_sessions(sessions: List[dict], process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> List[dict]:
    """This process's sessions: whole chains, round-robin over processes in
    the order of their sorted chain keys (a session without one is its own
    chain)."""
    initialized = dist.is_available() and dist.is_initialized()
    if process_id is None:
        process_id = dist.get_rank() if initialized else 0
    if not num_processes:
        num_processes = dist.get_world_size() if initialized else 1
    chains = {}
    for i, s in enumerate(sessions):
        chains.setdefault(s.get("chain", i), []).append(s)
    mine = []
    for k, chain_key in enumerate(sorted(chains, key=str)):
        if k % num_processes == process_id:
            mine.extend(chains[chain_key])
    return mine
