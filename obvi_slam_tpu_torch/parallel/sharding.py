"""Factor-axis sharding of global bundle adjustment over ranks.

Counterpart of ``obvi_slam_tpu/parallel/sharding.py``. The reference
annotates shardings and lets XLA insert the collectives; the port is
explicit SPMD: one process per rank (``torch.distributed``), each holding
the whole problem as built on every rank ("problems are built identically
on every host"), and ``shard_*`` hand each rank its contiguous slice of
every factor-axis array by the reference's rule:

  - an array's leading axis is sharded when it divides by the mesh size;
  - the plan's sharded fields are the factor -> pair maps and the cross
    rows (the reference's list, with the port's ``*_cross_dest``, which
    travels with its cross rows);
  - the state, cameras, ``free`` and the pair- and landmark-level plan
    arrays are replicated.

A factor table (or cross-row group) whose leading axis does not divide is
replicated, and its rows are masked on every rank but rank 0, so that each
factor counts once when the partial sums are all-reduced.
``schur.compute_step(..., mesh=mesh)`` then computes on each rank's rows and
combines through ``parallel.comm``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

# The plan's factor-axis fields, grouped by leading axis; the last of a
# cross group is the mask that rank 0 alone keeps when the group is
# replicated.
_PLAN_GROUPS = (
    ("rp_factor_pair",),
    ("bb_factor_pair",),
    ("pt_cross_a", "pt_cross_b", "pt_cross_dest", "pt_cross_mask"),
    ("ob_cross_a", "ob_cross_b", "ob_cross_dest", "ob_cross_mask"),
)


@dataclass(frozen=True)
class Mesh:
    """The ranks of one process group: ``size`` ranks, this process's
    ``rank``, the ``group`` (None: the default group) and the ``device``
    this rank computes on."""

    size: int
    rank: int
    group: object
    device: torch.device


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of an initialized process group (the default one when
    ``group`` is None). ``device`` defaults to the current CUDA device when
    there is one, else the CPU. Raises when no process group is
    initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group "
                           "(parallel.initialize_distributed or init_process_group)")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(dist.get_world_size(group), dist.get_rank(group), group, torch.device(device))


def check_mesh(mesh) -> None:
    """Raises unless ``mesh`` is a Mesh of an initialized process group."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, not {type(mesh).__name__}")
    if not dist.is_initialized():
        raise RuntimeError("the mesh's process group is not initialized")


def row_range(n: int, mesh) -> tuple:
    """This rank's contiguous share [lo, hi) of n rows (the first n % size
    ranks take one more)."""
    base, extra = divmod(n, mesh.size)
    lo = mesh.rank * base + min(mesh.rank, extra)
    return lo, lo + base + (1 if mesh.rank < extra else 0)


def _divides(x, mesh) -> bool:
    return x is not None and x.ndim >= 1 and x.shape[0] % mesh.size == 0


def _slice(x, mesh):
    lo, hi = row_range(x.shape[0], mesh)
    return x[lo:hi].clone()


def _masked_off(mask, mesh):
    """A replicated mask: kept on rank 0, all False elsewhere."""
    return mask if mesh.rank == 0 else torch.zeros_like(mask)


def replicate(tree, mesh):
    """Every rank already holds the whole value: returned as it is."""
    check_mesh(mesh)
    return tree


def _shard_table(table, mesh):
    if _divides(table.mask, mesh):
        return type(table)(*(_slice(x, mesh) for x in table))
    return table._replace(mask=_masked_off(table.mask, mesh))


def shard_tables(tables, mesh):
    """Each factor table sliced to this rank's rows, or replicated with its
    rows masked off rank 0 when its capacity does not divide."""
    check_mesh(mesh)
    return type(tables)(*(_shard_table(t, mesh) for t in tables))


def shard_weights(weights, mesh):
    """Weights sliced as their tables are (a replicated table's weights stay
    whole: its mask already zeroes its rows off rank 0)."""
    check_mesh(mesh)
    return type(weights)(*(_slice(w, mesh) if _divides(w, mesh) else w for w in weights))


def shard_plan(plan, mesh):
    """The factor -> pair maps and the cross rows sliced (or replicated,
    cross rows then masked off rank 0); pair-, landmark- and slot-level
    arrays replicated."""
    check_mesh(mesh)
    fields = plan._asdict()
    for group in _PLAN_GROUPS:
        if _divides(fields[group[0]], mesh):
            for name in group:
                fields[name] = _slice(fields[name], mesh)
        elif len(group) > 1:
            fields[group[-1]] = _masked_off(fields[group[-1]], mesh)
    return type(plan)(**fields)


def shard_aux(aux, tables, mesh):
    """TwoPhaseAux: the per-shape-row liveness follows the shape table."""
    if aux is None:
        return None
    live = aux.shape_live
    return aux._replace(shape_live=_slice(live, mesh) if _divides(tables.shape.mask, mesh)
                        else live)


def shard_problem(problem, mesh):
    """A built Problem for this rank: tables, weights and plan on the factor
    axis, state, cameras and free replicated, the host maps unchanged."""
    check_mesh(mesh)
    return replace(
        problem,
        tables=shard_tables(problem.tables, mesh),
        plan=shard_plan(problem.plan, mesh),
        weights=shard_weights(problem.weights, mesh),
        aux=shard_aux(problem.aux, problem.tables, mesh),
    )


def sharded_compute_step(mesh):
    """compute_step on this rank's shard; its outputs are equal on every
    rank (the step is broadcast from rank 0)."""
    from obvi_slam_tpu_torch.solver import schur as schur_mod

    check_mesh(mesh)

    def step(state, cams, tables, plan, free, weights, radius, huber, **kw):
        return schur_mod.compute_step(state, cams, tables, plan, free, weights, radius,
                                      huber, mesh=mesh, **kw)

    return step
