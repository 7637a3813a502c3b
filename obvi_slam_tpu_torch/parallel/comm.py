"""The collectives of the sharded solve, each reported to ``audit``.

Every collective of the port goes through these three functions, over the
process group of a ``sharding.Mesh``. They work with the gloo backend (CPU
and CUDA tensors) and NCCL (CUDA tensors); gloo has no ``reduce_scatter``
or ``send``/``recv`` on CUDA tensors, so the solve uses none of them: the
reference's ``ppermute`` halos become an ``all_gather`` of the boundary
block. Calls are collective: every rank of the mesh must issue the same
sequence with tensors of the same shapes and dtypes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from obvi_slam_tpu_torch.parallel import audit


def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """Elementwise sum (or "min") of ``x`` over the ranks, on every rank;
    ``x`` is left as it was."""
    audit.record("all-reduce", x.dtype, x.shape)
    out = x.detach().clone().contiguous()
    reduce_op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(out, op=reduce_op, group=mesh.group)
    return out


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """(mesh.size, *x.shape): rank r's ``x`` at row r, on every rank."""
    audit.record("all-gather", x.dtype, (mesh.size,) + tuple(x.shape))
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.stack(parts)


def broadcast(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank."""
    audit.record("broadcast", x.dtype, x.shape)
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=src if mesh.group is None else dist.get_global_rank(mesh.group, src),
                   group=mesh.group)
    return out
