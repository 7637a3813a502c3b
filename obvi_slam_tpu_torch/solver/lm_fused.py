"""Levenberg-Marquardt with Ceres trust-region semantics, and the two-phase
window solve.

Counterpart of ``obvi_slam_tpu/solver/lm_fused.py``: the same accept/reject
on relative decrease, radius update, function/gradient/parameter/radius
termination (codes 1-5, ``lm.TERMINATION_NAMES``) and non-monotonic
bookkeeping as its ``_run_lm``, in two forms:

- ``solve`` and ``solve_two_phase``: a host loop with one scalar readback
  per iteration (the step, candidate state and cost stay on the device).
  With a ``mesh`` (``parallel``) the tables, plan and weights are the rank's
  shard: the cost is all_reduced and the step is equal on every rank, so
  every accept, reject, radius and termination decision reads the same
  scalars on every rank and all ranks run the same iterations.
- ``solve_fused``, ``solve_two_phase_fused`` and their ``*_jit`` forms: the
  iteration is ``_lm_body``, a function of a carry of tensors with no host
  read, every update masked by ``running = (term == 0) & (it < max_it)`` so
  that a call after the end is an identity. On CPU tensors the body runs
  eagerly, one call per iteration. On CUDA tensors it is captured as a
  ``torch.cuda.CUDAGraph`` over static buffers (``_Graphs``) and replayed
  in chunks of ``CHUNK`` iterations, with one read of the running flag per
  chunk and one batched readback of the summaries at the end; the graphs
  are cached by everything that shapes them (``graph_stats``,
  ``clear_graphs``). There is no mesh form: collectives are not captured.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from typing import NamedTuple

import torch

from obvi_slam_tpu_torch import factors as fac
from obvi_slam_tpu_torch import ops
from obvi_slam_tpu_torch.parallel import comm
from obvi_slam_tpu_torch.solver import band_solve
from obvi_slam_tpu_torch.solver import schur as schur_mod
from obvi_slam_tpu_torch.solver import two_phase as tp_mod
from obvi_slam_tpu_torch.solver.lm import (
    TERMINATION_NAMES,
    IterationRecord,
    LMParams,
    LMSummary,
)
from obvi_slam_tpu_torch.timing import HOST_WAIT, timer
from obvi_slam_tpu_torch.types import BAState


def _cost(state, cams, tables, weights, huber, mesh=None):
    cost = _local_cost(state, cams, tables, weights, huber)
    return cost if mesh is None else comm.all_reduce(cost.reshape(1), mesh)[0]


def _local_cost(state, cams, tables, weights, huber):
    return fac.total_cost(
        state,
        cams,
        tables,
        huber_reproj=huber.reproj,
        huber_bbox=huber.bbox,
        huber_shape=huber.shape,
        huber_relpose=huber.relpose,
        huber_ltm=huber.ltm,
        invalid_error=huber.invalid_ellipse_error,
        reproj_weight=weights.reproj,
        bbox_weight=weights.bbox,
        shape_weight=weights.shape,
        relpose_weight=weights.relpose,
        ltm_weight=weights.ltm,
    )


def _sq(state):
    return sum((x * x).sum() for x in state)


def solve(
    state: BAState,
    cams,
    tables,
    plan,
    free,
    weights=None,
    params: LMParams = LMParams(),
    huber: schur_mod.HuberParams = schur_mod.HuberParams(),
    plain: bool = False,
    dense_schur=None,
    mesh=None,
):
    """Run LM from ``state``; returns (final_state, LMSummary) with one
    IterationRecord per iteration. ``plain``, ``dense_schur`` (None: the
    automatic path choice) and ``mesh`` are passed to compute_step."""
    if weights is None:
        weights = schur_mod.ones_weights(tables, dtype=state.poses.dtype)
    cost = _cost(state, cams, tables, weights, huber, mesh)
    with timer(HOST_WAIT):
        cost = float(cost)
    summary = LMSummary(initial_cost=cost, final_cost=cost)
    if params.max_num_iterations == 0:
        summary.termination = "MAX_ITERATIONS"
        return state, summary

    radius = params.initial_trust_region_radius
    decrease_factor = 2.0
    candidate_cost = reference_cost = cost
    acc_candidate = acc_reference = 0.0
    n_nonmonotonic = 0
    term = 0
    free_cols = [m[:, None] for m in free]
    while term == 0 and summary.num_iterations < params.max_num_iterations:
        delta, model_change, grad_max = schur_mod.compute_step(
            state, cams, tables, plan, free, weights, radius, huber, dense_schur=dense_schur,
            plain=plain, mesh=mesh,
        )
        new_state = BAState(*(x + d * m for x, d, m in zip(state, delta, free_cols)))
        new_cost = _cost(new_state, cams, tables, weights, huber, mesh)
        # The one device -> host readback of the iteration.
        scalars = torch.stack([model_change, grad_max, new_cost, _sq(delta), _sq(state)])
        with timer(HOST_WAIT):
            model_change, grad_max, new_cost, step2, x2 = scalars.tolist()
        step_norm, x_norm = math.sqrt(step2), math.sqrt(x2)

        cost_change = cost - new_cost
        valid_model = model_change > 0
        rho = cost_change / max(model_change, 1e-300) if valid_model else -1.0
        relative_decrease = rho
        if params.allow_non_monotonic_steps:
            hist_rho = (reference_cost - new_cost) / max(model_change, 1e-300)
            relative_decrease = max(rho, hist_rho)
        accepted = valid_model and relative_decrease > params.min_relative_decrease

        if accepted:
            # (2 rho - 1)^3 as _run_lm's integer power: two products.
            y = 2.0 * rho - 1.0
            new_radius = min(
                radius / max(1.0 / 3.0, 1.0 - y * y * y), params.max_trust_region_radius,
            )
            new_decrease = 2.0
        else:
            new_radius = radius / decrease_factor
            new_decrease = decrease_factor * 2.0

        if grad_max <= params.gradient_tolerance:
            term = 2
        elif accepted and abs(cost_change) <= params.function_tolerance * cost:
            term = 1
        elif accepted and step_norm <= params.parameter_tolerance * (
            x_norm + params.parameter_tolerance
        ):
            term = 3
        elif not accepted and new_radius < params.min_trust_region_radius:
            term = 4

        if params.allow_non_monotonic_steps and accepted:
            acc_candidate += cost_change
            acc_reference += cost_change
            if new_cost < candidate_cost:
                candidate_cost = new_cost
                acc_candidate = 0.0
            if cost_change >= 0:
                n_nonmonotonic = 0
                reference_cost = new_cost
                acc_reference = 0.0
            else:
                n_nonmonotonic += 1
                if n_nonmonotonic >= params.max_consecutive_nonmonotonic_steps:
                    reference_cost = candidate_cost
                    acc_reference = acc_candidate

        summary.iterations.append(IterationRecord(
            summary.num_iterations, cost, cost_change if accepted else 0.0,
            step_norm if accepted else 0.0, new_radius, accepted,
        ))
        summary.num_iterations += 1
        if accepted:
            summary.num_successful_steps += 1
            state, cost = new_state, new_cost
        else:
            summary.num_unsuccessful_steps += 1
        radius, decrease_factor = new_radius, new_decrease

    summary.final_cost = cost
    summary.termination = TERMINATION_NAMES[term or 5]
    return state, summary


def solve_two_phase(
    state, cams, tables, plan, free, weights, aux: tp_mod.TwoPhaseAux,
    params1: LMParams, params2: LMParams,
    huber: schur_mod.HuberParams, tp_cfg: tp_mod.TwoPhaseConfig,
    plain: bool = False, dense_schur=None, mesh=None,
):
    """One window iteration of the reference's two-phase optimization:
    phase-1 LM, outlier ranking + factor re-selection at the phase-1
    optimum, then phase-2 LM restarted from the input state. Returns
    (final_state, summary1, summary2). ``dense_schur`` and ``mesh`` as in
    ``solve`` (with a mesh, ``aux.shape_live`` is the rank's shard too)."""
    final1, summary1 = solve(
        state, cams, tables, plan, free, weights, params1, huber, plain=plain,
        dense_schur=dense_schur, mesh=mesh,
    )
    res = fac.all_residuals(final1, cams, tables, huber.invalid_ellipse_error)
    weights2 = tp_mod.reweight_on_device(
        tables, weights, res["reproj"], res["bbox"], aux, tp_cfg,
        n_pose=state.poses.shape[0], n_point=state.points.shape[0], mesh=mesh,
    )
    final2, summary2 = solve(
        state, cams, tables, plan, free, weights2, params2, huber, plain=plain,
        dense_schur=dense_schur, mesh=mesh,
    )
    return final2, summary1, summary2


# ---- the fused solves ------------------------------------------------------

# Iterations replayed on the card between two reads of the running flag.
CHUNK = 1
# Bounds of the graph cache: entries, and bytes of their static buffers and
# graph pools; the least recently used entry goes first.
MAX_GRAPH_ENTRIES = 128
MAX_GRAPH_BYTES = 8 << 30


class _Carry(NamedTuple):
    """The loop state of ``_lm_body`` (``_run_lm``'s carry), all tensors on
    the state's device: costs and radii in the state's dtype, counters and
    the termination code in int32, records (rec_cap,) long."""

    state: BAState
    init_cost: torch.Tensor
    cost: torch.Tensor
    radius: torch.Tensor
    decrease_factor: torch.Tensor
    it: torch.Tensor
    term: torch.Tensor  # 0 = running
    num_success: torch.Tensor
    num_fail: torch.Tensor
    # Non-monotonic bookkeeping (Ceres TrustRegionMinimizer).
    candidate_cost: torch.Tensor
    reference_cost: torch.Tensor
    acc_candidate_changes: torch.Tensor
    acc_reference_changes: torch.Tensor
    num_consecutive_nonmonotonic: torch.Tensor
    # Per-iteration records (length 1 and untouched without records).
    rec_cost: torch.Tensor
    rec_change: torch.Tensor
    rec_step_norm: torch.Tensor
    rec_radius: torch.Tensor
    rec_accepted: torch.Tensor
    # (term == 0) & (it < max_it): the flag the replay loop reads.
    running: torch.Tensor


class _StaticParams(NamedTuple):
    """The LMParams bits that shape the body: the non-monotonic branch and
    the record arrays (rec_cap = max_num_iterations with records, else 1)."""

    allow_non_monotonic_steps: bool
    rec_cap: int
    with_records: bool


# Packing order of the dynamic-parameter vector (see _split_params).
_DYN_ORDER = (
    "max_num_iterations",
    "function_tolerance",
    "gradient_tolerance",
    "parameter_tolerance",
    "initial_trust_region_radius",
    "max_trust_region_radius",
    "min_trust_region_radius",
    "min_relative_decrease",
    "max_consecutive_nonmonotonic_steps",
)


def _split_params(params: LMParams, dtype, device, with_records: bool):
    """LMParams -> (dyn vector on ``device`` in ``dtype``, static part). The
    numeric fields ride as one tensor, so that solves with other numbers
    (phases, PGO) replay the same graph."""
    with timer(HOST_WAIT):  # a copy from pageable host memory waits on the stream
        dyn = torch.tensor([float(getattr(params, f)) for f in _DYN_ORDER], dtype=dtype,
                           device=device)
    statics = _StaticParams(
        allow_non_monotonic_steps=bool(params.allow_non_monotonic_steps),
        rec_cap=max(int(params.max_num_iterations), 1) if with_records else 1,
        with_records=bool(with_records),
    )
    return dyn, statics


def _init_carry(state, cams, tables, weights, dyn, statics: _StaticParams, huber) -> _Carry:
    """The carry before the first iteration; makes no host read."""
    dtype, device = state.poses.dtype, state.poses.device
    cost = _local_cost(state, cams, tables, weights, huber)
    zero_i = torch.zeros((), dtype=torch.int32, device=device)
    zero_f = torch.zeros((), dtype=dtype, device=device)
    rec = torch.zeros(statics.rec_cap, dtype=dtype, device=device)
    return _Carry(
        state=state, init_cost=cost, cost=cost, radius=dyn[4].clone(),
        decrease_factor=torch.full((), 2.0, dtype=dtype, device=device),
        it=zero_i, term=zero_i, num_success=zero_i, num_fail=zero_i,
        candidate_cost=cost, reference_cost=cost,
        acc_candidate_changes=zero_f, acc_reference_changes=zero_f,
        num_consecutive_nonmonotonic=zero_i,
        rec_cost=rec, rec_change=rec, rec_step_norm=rec, rec_radius=rec,
        rec_accepted=torch.zeros(statics.rec_cap, dtype=torch.bool, device=device),
        running=dyn[0].to(torch.int32) > 0,
    )


def _lm_body(c: _Carry, cams, tables, plan, free, weights, dyn, statics: _StaticParams, huber,
             dense_schur=None, plain=False) -> _Carry:
    """One trust-region iteration of ``_run_lm``'s while body on a carry of
    tensors, with no host read. Every update is masked by ``c.running``, so
    a call after the loop's end returns the carry unchanged, bit for bit."""
    max_it = dyn[0].to(torch.int32)
    func_tol, grad_tol, param_tol = dyn[1], dyn[2], dyn[3]
    max_radius, min_radius = dyn[5], dyn[6]
    min_rel_decrease = dyn[7]
    max_consec_nm = dyn[8].to(torch.int32)
    running = c.running

    delta, model_change, grad_max = schur_mod.compute_step(
        c.state, cams, tables, plan, free, weights, c.radius, huber, dense_schur=dense_schur,
        plain=plain,
    )
    new_state = BAState(*(x + d * m[:, None] for x, d, m in zip(c.state, delta, free)))
    new_cost = _local_cost(new_state, cams, tables, weights, huber)
    step_norm = torch.sqrt(_sq(delta))
    x_norm = torch.sqrt(_sq(c.state))

    cost_change = c.cost - new_cost
    valid_model = model_change > 0
    rho = torch.where(valid_model, cost_change / torch.clamp_min(model_change, 1e-300),
                      torch.full_like(cost_change, -1.0))
    if statics.allow_non_monotonic_steps:
        hist_rho = (c.reference_cost - new_cost) / torch.clamp_min(model_change, 1e-300)
        relative_decrease = torch.maximum(rho, hist_rho)
    else:
        relative_decrease = rho
    accepted = valid_model & (relative_decrease > min_rel_decrease)

    # Radius update.
    shrink = c.radius / c.decrease_factor
    y = 2.0 * rho - 1.0
    grow = torch.minimum(c.radius / torch.clamp_min(1.0 - y * y * y, 1.0 / 3.0), max_radius)
    new_radius = torch.where(accepted, grow, shrink)
    new_decrease = torch.where(accepted, torch.full_like(c.decrease_factor, 2.0),
                               c.decrease_factor * 2.0)

    # Termination checks.
    grad_conv = grad_max <= grad_tol
    func_conv = accepted & (cost_change.abs() <= func_tol * c.cost)
    param_conv = accepted & (step_norm <= param_tol * (x_norm + param_tol))
    radius_conv = ~accepted & (new_radius < min_radius)
    code = torch.zeros_like(c.term)
    for conv, value in ((radius_conv, 4), (param_conv, 3), (func_conv, 1), (grad_conv, 2)):
        code = torch.where(conv, torch.full_like(code, value), code)

    # Non-monotonic bookkeeping on accepted steps.
    if statics.allow_non_monotonic_steps:
        zero = torch.zeros_like(cost_change)
        acc_cand = c.acc_candidate_changes + cost_change
        acc_ref = c.acc_reference_changes + cost_change
        better_candidate = new_cost < c.candidate_cost
        cand_cost = torch.where(better_candidate, new_cost, c.candidate_cost)
        acc_cand = torch.where(better_candidate, zero, acc_cand)
        monotonic = cost_change >= 0
        n_nm = torch.where(monotonic, torch.zeros_like(c.num_consecutive_nonmonotonic),
                           c.num_consecutive_nonmonotonic + 1)
        hit_limit = n_nm >= max_consec_nm
        ref_cost = torch.where(
            monotonic, new_cost, torch.where(hit_limit, cand_cost, c.reference_cost))
        acc_ref = torch.where(monotonic, zero, torch.where(hit_limit, acc_cand, acc_ref))
        cand_cost = torch.where(accepted, cand_cost, c.candidate_cost)
        ref_cost = torch.where(accepted, ref_cost, c.reference_cost)
        acc_cand = torch.where(accepted, acc_cand, c.acc_candidate_changes)
        acc_ref = torch.where(accepted, acc_ref, c.acc_reference_changes)
        n_nm = torch.where(accepted, n_nm, c.num_consecutive_nonmonotonic)
    else:
        cand_cost, ref_cost = c.candidate_cost, c.reference_cost
        acc_cand, acc_ref = c.acc_candidate_changes, c.acc_reference_changes
        n_nm = c.num_consecutive_nonmonotonic

    def keep(new, old):
        return torch.where(running, new, old)

    def take(new, old):
        return keep(torch.where(accepted, new, old), old)

    records = (c.rec_cost, c.rec_change, c.rec_step_norm, c.rec_radius, c.rec_accepted)
    if statics.with_records:
        hit = (torch.arange(statics.rec_cap, device=c.it.device) == c.it) & running
        zero = torch.zeros_like(cost_change)
        values = (c.cost, torch.where(accepted, cost_change, zero),
                  torch.where(accepted, step_norm, zero), new_radius, accepted)
        records = tuple(torch.where(hit, v, r) for v, r in zip(values, records))

    it = c.it + running.to(torch.int32)
    term = keep(code, c.term)
    return _Carry(
        state=BAState(*(take(a, b) for a, b in zip(new_state, c.state))),
        init_cost=c.init_cost,
        cost=take(new_cost, c.cost),
        radius=keep(new_radius, c.radius),
        decrease_factor=keep(new_decrease, c.decrease_factor),
        it=it,
        term=term,
        num_success=c.num_success + (running & accepted).to(torch.int32),
        num_fail=c.num_fail + (running & ~accepted).to(torch.int32),
        candidate_cost=keep(cand_cost, c.candidate_cost),
        reference_cost=keep(ref_cost, c.reference_cost),
        acc_candidate_changes=keep(acc_cand, c.acc_candidate_changes),
        acc_reference_changes=keep(acc_ref, c.acc_reference_changes),
        num_consecutive_nonmonotonic=keep(n_nm, c.num_consecutive_nonmonotonic),
        rec_cost=records[0],
        rec_change=records[1],
        rec_step_norm=records[2],
        rec_radius=records[3],
        rec_accepted=records[4],
        running=(term == 0) & (it < max_it),
    )


def _finished(c: _Carry) -> _Carry:
    """The carry as ``_run_lm`` returns it: term 0 (the iteration bound) -> 5."""
    return c._replace(term=torch.where(c.term == 0, torch.full_like(c.term, 5), c.term))


def _run_eager(c: _Carry, body) -> _Carry:
    """The loop on the host: one body call per iteration (CPU tensors)."""
    while bool(c.running):
        c = body(c)
    return c


# ---- pytrees of tensors ------------------------------------------------------


def _map(fn, tree):
    """``fn`` on every tensor of nested dicts and (named) tuples; other
    leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_map(fn, t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, tuple):
        return [x for t in tree for x in _tensors(t)]
    return []


def _signature(tree):
    """Shapes and dtypes of the tensors, the values of the other leaves."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, tuple):
        return (type(tree).__name__,) + tuple(_signature(t) for t in tree)
    return tree


def _copy_into(dst, src):
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


# ---- CUDA graphs -------------------------------------------------------------

_graph_cache: "OrderedDict[tuple, _Graphs]" = OrderedDict()
_side_streams: dict = {}
# Since the last reset_graph_stats(): entries built, graphs captured and the
# seconds their captures took, graph replays, reads of the running flag,
# entries evicted, and ``lm_iterations``: the LM iterations of every fused
# solve whose summary was read back (each phase of a two-phase solve; on the
# CPU too); and now: entries held and their bytes.
graph_stats: dict = {}


def reset_graph_stats() -> None:
    graph_stats.update(entries_built=0, captures=0, capture_s=0.0, replays=0, flag_reads=0,
                       evictions=0, lm_iterations=0)
    graph_stats.update(entries=len(_graph_cache),
                       bytes=sum(e.bytes for e in _graph_cache.values()))


reset_graph_stats()


def clear_graphs() -> None:
    """Drops every cached graph and its buffers."""
    _graph_cache.clear()
    graph_stats.update(entries=0, bytes=0)


def _counts():
    return ops.kernel_launches(), dict(schur_mod.path_counts)


class _Captured(NamedTuple):
    graph: object  # torch.cuda.CUDAGraph
    launches: dict  # kernel wrapper calls made while capturing: one replay's launches
    paths: dict  # Schur path counts of one replay


class _Graphs:
    """One cache entry: static copies of a problem's tensors (``inputs``),
    the static carry, and the graphs captured over them. Each function runs
    eagerly at its first use (the warm-up capture needs, and a real call)
    and is captured at its second; a captured function is replayed. All of
    it runs on the entry's device's side stream."""

    def __init__(self, inputs: dict, carry: _Carry, out1: _Carry = None):
        self.inputs = inputs
        self.carry = carry
        self.out1 = out1  # the two-phase solve's phase-1 carry
        self.graphs = {}
        self.used = {"start"}  # the entry's carry comes from an eager start
        self.bytes = sum(t.numel() * t.element_size() for t in _tensors((inputs, carry, out1)))

    def run(self, name, fn):
        captured = self.graphs.get(name)
        if captured is None and name not in self.used:
            self.used.add(name)
            fn()
            return
        if captured is None:
            captured = self.graphs[name] = self._capture(fn)
        captured.graph.replay()
        graph_stats["replays"] += 1
        ops.add_kernel_launches(captured.launches)
        schur_mod.add_path_counts(captured.paths)

    def _capture(self, fn) -> _Captured:
        launches0, paths0 = _counts()
        device = self.carry.cost.device
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with timer("fused_capture"):
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        graph_stats["captures"] += 1
        graph_stats["capture_s"] += time.perf_counter() - t0
        grown = torch.cuda.memory_reserved(device) - reserved
        self.bytes += grown
        graph_stats["bytes"] += grown
        launches1, paths1 = _counts()
        ops.reset_kernel_launches()
        ops.add_kernel_launches(launches0)
        schur_mod.reset_path_counts()
        schur_mod.add_path_counts(paths0)
        return _Captured(
            graph,
            {k: launches1[k] - launches0.get(k, 0) for k in launches1},
            {k: v - paths0.get(k, 0) for k, v in paths1.items() if v != paths0.get(k, 0)},
        )


def _entry(key, inputs: dict, make_carry, two_phase=False):
    """The cached entry of ``key`` with ``inputs`` copied in, and whether it
    was built here (its carry then ``make_carry``'s on the static inputs,
    an eager start)."""
    entry = _graph_cache.get(key)
    if entry is not None:
        _graph_cache.move_to_end(key)
        _copy_into(entry.inputs, inputs)
        return entry, False
    while _graph_cache and (len(_graph_cache) >= MAX_GRAPH_ENTRIES
                            or graph_stats["bytes"] > MAX_GRAPH_BYTES):
        _, old = _graph_cache.popitem(last=False)
        graph_stats["bytes"] -= old.bytes
        graph_stats["evictions"] += 1
    static = _map(torch.clone, inputs)
    carry = _map(torch.clone, make_carry(static))
    entry = _Graphs(static, carry, _map(torch.clone, carry) if two_phase else None)
    _graph_cache[key] = entry
    graph_stats["entries_built"] += 1
    graph_stats["entries"] = len(_graph_cache)
    graph_stats["bytes"] += entry.bytes
    return entry, True


def _replay_loop(entry, name, fn, max_it):
    """``fn`` (one masked iteration) in chunks of CHUNK, the running flag
    read after each chunk; at most ``max_it`` calls."""
    done = 0
    while done < max_it:
        for _ in range(min(CHUNK, max_it - done)):
            entry.run(name, fn)
            done += 1
        graph_stats["flag_reads"] += 1
        with timer(HOST_WAIT):
            running = bool(entry.carry.running)
        if not running:
            return


class _OnSideStream:
    """Runs the block on the device's side stream, ordered after the work
    already queued on the current stream and before the work queued after
    it; the cuSOLVER backend for the linear algebra (MAGMA may sync)."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        side = _side_streams.get(self.device)
        if side is None:
            side = _side_streams[self.device] = torch.cuda.Stream(self.device)
        self.current = torch.cuda.current_stream(self.device)
        side.wait_stream(self.current)
        self.stream_ctx = torch.cuda.stream(side)
        self.stream_ctx.__enter__()
        self.linalg = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        return side

    def __exit__(self, *exc):
        torch.backends.cuda.preferred_linalg_library(self.linalg)
        side = torch.cuda.current_stream(self.device)
        self.stream_ctx.__exit__(*exc)
        self.current.wait_stream(side)
        return False


def _graph_key(kind, state, plan, inputs, statics, huber, dense_schur, plain, extra=()):
    """Everything that shapes a captured program: the inputs' shapes and
    dtypes, the statics, the values baked in (Huber, two-phase config), the
    Schur paths of the step and the switches it reads."""
    paths = schur_mod.choose_paths(plan, state.poses.shape[0], state.points.shape[0],
                                   dense_schur)
    return (kind, state.poses.device, _signature(inputs), statics, huber, plain,
            paths, band_solve._BAND_CR, band_solve._BAND_CR_MIN_NB,
            torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled()) + tuple(extra)


def _check_device(state):
    device = state.poses.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused solve: unsupported device {device}")
    return device


def _body_of(p: dict, statics, huber, dense_schur, plain):
    """``_lm_body`` on the problem ``p`` (inputs by name) as carry -> carry."""
    return lambda c: _lm_body(c, p["cams"], p["tables"], p["plan"], p["free"], p["weights"],
                              p["dyn"], statics, huber, dense_schur, plain)


def _carry_of(p: dict, statics, huber):
    return _init_carry(p["state"], p["cams"], p["tables"], p["weights"], p["dyn"], statics, huber)


def _fused_core(state, cams, tables, plan, free, weights, params, huber, dense_schur,
                with_records, plain):
    """(final carry, term 0 -> 5) of one LM solve; CUDA graphs on the card."""
    device = _check_device(state)
    dyn, statics = _split_params(params, state.poses.dtype, device, with_records)
    inputs = dict(state=state, cams=cams, tables=tables, plan=plan, free=free,
                  weights=weights, dyn=dyn)
    if device.type == "cpu":
        body = _body_of(inputs, statics, huber, dense_schur, plain)
        return _finished(_run_eager(_carry_of(inputs, statics, huber), body))

    with _OnSideStream(device):
        with timer("fused_graph_entry"):
            key = _graph_key("solve", state, plan, inputs, statics, huber, dense_schur, plain)
            entry, built = _entry(key, inputs, lambda p: _carry_of(p, statics, huber))
        p, c = entry.inputs, entry.carry
        body = _body_of(p, statics, huber, dense_schur, plain)
        if not built:
            entry.run("start", lambda: _copy_into(c, _carry_of(p, statics, huber)))
        _replay_loop(entry, "body", lambda: _copy_into(c, body(c)),
                     int(params.max_num_iterations))
        return _map(torch.clone, _finished(c))


def _two_phase_core(state, cams, tables, plan, free, weights, aux, params1, params2, huber,
                    tp_cfg, dense_schur, with_records, plain):
    """(final carry 1, final carry 2), both term 0 -> 5, of one window's
    two-phase solve: phase-1 LM, ``reweight_on_device`` at its optimum and
    phase-2 LM from the input state, as ``_solve_two_phase_core``."""
    device = _check_device(state)
    dtype = state.poses.dtype
    dyn1, st1 = _split_params(params1, dtype, device, with_records)
    dyn2, st2 = _split_params(params2, dtype, device, with_records)
    rec_cap = max(st1.rec_cap, st2.rec_cap)
    st1, st2 = st1._replace(rec_cap=rec_cap), st2._replace(rec_cap=rec_cap)
    n_pose, n_point = state.poses.shape[0], state.points.shape[0]

    def body_of(p, st):
        return _body_of(p, st, huber, dense_schur, plain)

    def weights2_of(p, c):
        res = fac.all_residuals(c.state, p["cams"], p["tables"], huber.invalid_ellipse_error)
        return tp_mod.reweight_on_device(p["tables"], p["weights"], res["reproj"], res["bbox"],
                                         p["aux"], tp_cfg, n_pose=n_pose, n_point=n_point)

    inputs = dict(state=state, cams=cams, tables=tables, plan=plan, free=free,
                  weights=weights, aux=aux, dyn=dyn1, dyn2=dyn2)
    if device.type == "cpu":
        final1 = _run_eager(_carry_of(inputs, st1, huber), body_of(inputs, st1))
        p2 = dict(inputs, weights=weights2_of(inputs, final1), dyn=dyn2)
        final2 = _run_eager(_carry_of(p2, st2, huber), body_of(p2, st2))
        return _finished(final1), _finished(final2)

    with _OnSideStream(device):
        with timer("fused_graph_entry"):
            key = _graph_key("two_phase", state, plan, inputs, (st1, st2), huber, dense_schur,
                             plain, extra=(tp_cfg,))
            entry, built = _entry(key, inputs, lambda p: _carry_of(p, st1, huber),
                                  two_phase=True)
        p, c, out1 = entry.inputs, entry.carry, entry.out1

        def switch():
            _copy_into(out1, c)
            _copy_into(p["weights"], weights2_of(p, c))
            p["dyn"].copy_(p["dyn2"])
            _copy_into(c, _carry_of(p, st2, huber))

        if not built:
            entry.run("start", lambda: _copy_into(c, _carry_of(p, st1, huber)))
        for k, (st, max_it) in enumerate(((st1, params1.max_num_iterations),
                                          (st2, params2.max_num_iterations))):
            if k:
                entry.run("switch", switch)
            body = body_of(p, st)
            _replay_loop(entry, ("body", st.allow_non_monotonic_steps),
                         lambda: _copy_into(c, body(c)), int(max_it))
        return _map(torch.clone, (_finished(out1), _finished(c)))


def _packed(c: _Carry):
    """The summary's scalars and records of a finished carry as one f64
    vector (exact: int32 counts and f32 values are f64 numbers)."""
    head = torch.stack([c.init_cost, c.cost]).double()
    counts = torch.stack([c.it, c.num_success, c.num_fail, c.term]).double()
    recs = [r.double() for r in (c.rec_cost, c.rec_change, c.rec_step_norm, c.rec_radius,
                                 c.rec_accepted)]
    return torch.cat([head, counts, *recs])


def _summary(values, with_records: bool) -> LMSummary:
    """LMSummary from ``_packed``'s host values."""
    n_rec = (len(values) - 6) // 5
    init_cost, final_cost, it, n_success, n_fail, term = values[:6]
    graph_stats["lm_iterations"] += int(it)
    summary = LMSummary(initial_cost=init_cost, final_cost=final_cost,
                        num_iterations=int(it), num_successful_steps=int(n_success),
                        num_unsuccessful_steps=int(n_fail),
                        termination=TERMINATION_NAMES[int(term)])
    if with_records:
        rc, rch, rsn, rr, ra = (values[6 + k * n_rec: 6 + (k + 1) * n_rec] for k in range(5))
        summary.iterations = [
            IterationRecord(i, rc[i], rch[i], rsn[i], rr[i], bool(ra[i]))
            for i in range(int(it))
        ]
    return summary


def solve_fused_jit(
    state, cams, tables, plan, free, weights, params: LMParams, huber,
    dense_schur=None, with_records=False, plain=False,
):
    """The fused solve's device result, with no host read after the loop:
    (final carry, initial cost). The carry's fields are ``_run_lm``'s
    (``state``, ``cost``, ``it``, ``term``, ..., ``rec_*``), copied out of
    the graph's buffers."""
    final = _fused_core(state, cams, tables, plan, free, weights, params, huber, dense_schur,
                        with_records, plain)
    return final, final.init_cost


def solve_two_phase_jit(
    state, cams, tables, plan, free, weights, aux,
    params1: LMParams, params2: LMParams, huber, tp_cfg,
    dense_schur=None, with_records=False, plain=False,
):
    """Both phases' device results: (final1, init_cost1, final2, init_cost2)."""
    final1, final2 = _two_phase_core(
        state, cams, tables, plan, free, weights, aux, params1, params2, huber, tp_cfg,
        dense_schur, with_records, plain)
    return final1, final1.init_cost, final2, final2.init_cost


def solve_two_phase_fused(
    state, cams, tables, plan, free, weights, aux,
    params1: LMParams, params2: LMParams,
    huber: schur_mod.HuberParams, tp_cfg: tp_mod.TwoPhaseConfig,
    with_records: bool = False, dense_schur=None, plain: bool = False,
):
    """``solve_two_phase`` fused: (final_state, summary1, summary2), with one
    batched device -> host readback for both phases' summaries. Summaries
    carry IterationRecords only ``with_records``."""
    final1, _, final2, _ = solve_two_phase_jit(
        state, cams, tables, plan, free, weights, aux, params1, params2, huber, tp_cfg,
        dense_schur=dense_schur, with_records=with_records, plain=plain)
    packed = torch.cat([_packed(final1), _packed(final2)])
    with timer(HOST_WAIT):
        host = packed.cpu().tolist()
    half = len(host) // 2
    return (final2.state, _summary(host[:half], with_records),
            _summary(host[half:], with_records))


def solve_fused(
    state,
    cams,
    tables,
    plan,
    free,
    weights=None,
    params: LMParams = LMParams(),
    huber: schur_mod.HuberParams = schur_mod.HuberParams(),
    with_records: bool = False,
    dense_schur=None,
    plain: bool = False,
):
    """``solve`` fused: (final_state, LMSummary) with one batched readback
    of the summary. Summaries carry IterationRecords only ``with_records``."""
    if weights is None:
        weights = schur_mod.ones_weights(tables, dtype=state.poses.dtype)
    if params.max_num_iterations == 0:
        cost = _local_cost(state, cams, tables, weights, huber)
        with timer(HOST_WAIT):
            cost = float(cost)
        return state, LMSummary(initial_cost=cost, final_cost=cost, termination="MAX_ITERATIONS")
    final, _ = solve_fused_jit(state, cams, tables, plan, free, weights, params, huber,
                               dense_schur=dense_schur, with_records=with_records, plain=plain)
    packed = _packed(final)
    with timer(HOST_WAIT):
        host = packed.cpu().tolist()
    return final.state, _summary(host, with_records)
