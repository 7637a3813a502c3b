#!/usr/bin/env python3
"""Where the LM stops on the synthetic phases of ``chip_smoke.py``, and how
far apart two runs' final costs fall.

    python3 lm_stop_spread.py gaps         # on the card
    python3 lm_stop_spread.py trajectory   # on the card
    python3 lm_stop_spread.py same-length  # on the card
    python3 lm_stop_spread.py repeat       # on the card
    python3 lm_stop_spread.py crawl        # on the CPU, a small problem

- ``gaps``: per phase, repeated f32 two-phase solves on the graph path (each
  the first use of its graphs, as chip_smoke's gate runs it), each against
  the f64 plain run with its factor selection (default parameters) and the
  first ten against one of 400 iterations with the tolerances at 0.
- ``trajectory``: per phase, six f32 solves' final costs; then under
  deterministic algorithms each phase's f64 solve, plain and through the
  kernels, at the default parameters and for 1000 iterations with the
  tolerances at 0, with the cost along the way.
- ``same-length``: per phase, f32 solves on the graph path and on the host
  loop, each against f64 plain references of the default parameters and of
  the f32 phase's own iteration count (tolerances at 0).
- ``repeat``: per phase, three times from fresh graphs, chip_smoke's
  ``fused`` cost gate as it runs it: under ``chip_smoke.deterministic()``
  the f32 graph-path solve and the f64 plain references with its factor
  selection; the gaps must repeat.
- ``crawl``: ``synthetic_problem(32, 1024, 16)`` in f64 on the CPU, 300
  iterations with the tolerances at 0 and a default solve, with the objects
  free and with them fixed.

Each mode prints one line per run and a summary; the card's name and power
limit come last.
"""

import sys
import time

import numpy as np
import torch

LABELS = ("window", "global", "scale_1024", "loop_768", "loop_1024")


def fixed(n):
    from obvi_slam_tpu_torch.solver.lm import LMParams

    return LMParams(max_num_iterations=n, function_tolerance=0.0, gradient_tolerance=0.0,
                    parameter_tolerance=0.0)


def f32_run(cs, prob32, fused=True):
    """One f32 two-phase solve from fresh graphs: (s1, s2, phase-2 weights
    in f64)."""
    from obvi_slam_tpu_torch.solver import lm_fused, schur as schur_mod, two_phase as tp_mod

    lm_fused.clear_graphs()
    with cs.Spy(tp_mod, "reweight_on_device") as sel:
        _, s1, s2, _ = cs.run_two_phase(prob32, plain=False, fused=fused)
    return s1, s2, schur_mod.FactorWeights(*(w.double() for w in sel.result))


def gaps(cs):
    from obvi_slam_tpu_torch.solver import lm_fused
    from obvi_slam_tpu_torch.solver.lm import LMParams

    runs = dict(window=40, global_=8, scale_1024=6, loop_768=6, loop_1024=6)
    for label, n in runs.items():
        label = label.rstrip("_")
        t0 = time.perf_counter()
        prob64 = cs.phase_problem(label, np.float64)
        prob32 = cs.phase_problem(label, np.float32)
        state, _, cams, tables, pl, free, weights, huber = prob64

        def ref(w, p):
            return lm_fused.solve_fused(state, cams, tables, pl, free, w, p, huber,
                                        plain=True)[1]

        r1 = ref(weights, LMParams())
        g1, g2 = [], []
        for k in range(n):
            s1, s2, w2 = f32_run(cs, prob32)
            r2 = ref(w2, LMParams())
            r2t = ref(w2, fixed(400)) if k < 10 else None
            g1.append(abs(s1.final_cost - r1.final_cost) / r1.final_cost)
            g2.append(abs(s2.final_cost - r2.final_cost) / r2.final_cost)
            print(f"{label} {k}: f32 {s1.final_cost!r} {s1.termination} {s1.num_iterations} | "
                  f"{s2.final_cost!r} {s2.termination} {s2.num_iterations}; f64 plain phase 2 "
                  f"{r2.final_cost!r} {r2.termination} {r2.num_iterations}; 400 iterations "
                  f"{None if r2t is None else r2t.final_cost!r}; gaps {g1[-1]:.3e} {g2[-1]:.3e}",
                  flush=True)
        print(f"SUMMARY {label}: f64 plain phase 1 {r1.final_cost!r} {r1.termination} "
              f"{r1.num_iterations}; gap1 max {max(g1):.3e} median {np.median(g1):.3e}; gap2 max "
              f"{max(g2):.3e} median {np.median(g2):.3e} [{time.perf_counter() - t0:.1f} s]",
              flush=True)
        lm_fused.clear_graphs()


def trajectory(cs):
    from obvi_slam_tpu_torch.solver import lm_fused
    from obvi_slam_tpu_torch.solver.lm import LMParams

    marks = (25, 50, 100, 150, 200, 300, 400, 600, 800, 999)
    for label in LABELS:
        t0 = time.perf_counter()
        prob64 = cs.phase_problem(label, np.float64)
        prob32 = cs.phase_problem(label, np.float32)
        state, _, cams, tables, pl, free, weights, huber = prob64
        runs = [f32_run(cs, prob32) for _ in range(6)]
        print(label, "f32 final costs", [(s1.final_cost, s2.final_cost) for s1, s2, _ in runs],
              flush=True)
        with cs.deterministic():
            for phase, w in ((1, weights), (2, runs[0][2])):
                for name, params, rec in (("default", LMParams(), False),
                                          ("1000 iterations", fixed(1000), True)):
                    for plain in (True, False):
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        _, s = lm_fused.solve_fused(state, cams, tables, pl, free, w, params,
                                                    huber, with_records=rec, plain=plain)
                        torch.cuda.synchronize()
                        line = (f"{label} phase {phase} f64 {'plain' if plain else 'kernels'} "
                                f"deterministic {name}: {s.final_cost!r} {s.termination} "
                                f"{s.num_iterations} iterations {time.perf_counter() - t1:.2f} s")
                        if rec:
                            costs = [r.cost for r in s.iterations]
                            line += " costs " + " ".join(f"{m}:{costs[m]!r}" for m in marks
                                                         if m < len(costs))
                        print(line, flush=True)
        lm_fused.clear_graphs()
        print(f"[{label} {time.perf_counter() - t0:.1f} s]", flush=True)


def same_length(cs):
    from obvi_slam_tpu_torch.solver import lm_fused
    from obvi_slam_tpu_torch.solver.lm import LMParams

    runs = dict(window=(40, 10), global_=(12, 5), scale_1024=(8, 3), loop_768=(8, 3),
                loop_1024=(8, 3))
    for label, counts in runs.items():
        label = label.rstrip("_")
        t0 = time.perf_counter()
        prob64 = cs.phase_problem(label, np.float64)
        prob32 = cs.phase_problem(label, np.float32)
        state, _, cams, tables, pl, free, weights, huber = prob64
        r1 = lm_fused.solve_fused(state, cams, tables, pl, free, weights, LMParams(), huber,
                                  plain=True)[1]
        for kind, n in zip(("fused", "eager"), counts):
            solve = lm_fused.solve_fused if kind == "fused" else lm_fused.solve
            worst_default = worst_same = 0.0
            for k in range(n):
                s1, s2, w2 = f32_run(cs, prob32, fused=kind == "fused")

                def ref(w, p):
                    return solve(state, cams, tables, pl, free, w, p, huber, plain=True)[1]

                r2 = ref(w2, LMParams())
                n1, n2 = ref(weights, fixed(s1.num_iterations)), ref(w2, fixed(s2.num_iterations))
                default = [abs(s1.final_cost - r1.final_cost) / r1.final_cost,
                           abs(s2.final_cost - r2.final_cost) / r2.final_cost]
                same = [abs(s1.final_cost - n1.final_cost) / n1.final_cost,
                        abs(s2.final_cost - n2.final_cost) / n2.final_cost]
                worst_default, worst_same = max(worst_default, *default), max(worst_same, *same)
                print(f"{label} {kind} {k}: f32 {s1.num_iterations} {s1.termination} "
                      f"{s1.final_cost:.6f} | {s2.num_iterations} {s2.termination} "
                      f"{s2.final_cost:.6f}; same-length f64 {n1.final_cost:.6f} | "
                      f"{n2.final_cost:.6f}; default f64 phase 2 {r2.num_iterations} "
                      f"{r2.final_cost:.6f}; gaps to default {default[0]:.3e} {default[1]:.3e}, "
                      f"to same-length {same[0]:.3e} {same[1]:.3e}", flush=True)
            print(f"SUMMARY {label} {kind}: worst gap to default {worst_default:.3e}, to "
                  f"same-length {worst_same:.3e} [{time.perf_counter() - t0:.1f} s]",
                  flush=True)
            lm_fused.clear_graphs()


def repeat(cs):
    from obvi_slam_tpu_torch.solver import lm_fused
    from obvi_slam_tpu_torch.solver.lm import LMParams

    for label in LABELS:
        prob64 = cs.phase_problem(label, np.float64)
        prob32 = cs.phase_problem(label, np.float32)
        state, _, cams, tables, pl, free, weights, huber = prob64
        seen = []
        for _ in range(3):
            with cs.deterministic():
                s1, s2, w2 = f32_run(cs, prob32)
                r1, r2 = (lm_fused.solve_fused(state, cams, tables, pl, free, w, LMParams(),
                                               huber, plain=True)[1] for w in (weights, w2))
            seen.append(tuple(abs(a.final_cost - b.final_cost) / b.final_cost
                              for a, b in ((s1, r1), (s2, r2))))
        lm_fused.clear_graphs()
        print(f"{label}: deterministic gaps {', '.join(f'{a:.6e} {b:.6e}' for a, b in seen)}; "
              f"{'equal' if len(set(seen)) == 1 else 'NOT equal'}", flush=True)


def crawl():
    import obvi_slam_tpu_torch as ot
    from obvi_slam_tpu_torch import types as T
    from obvi_slam_tpu_torch.solver import lm_fused
    from obvi_slam_tpu_torch.solver.lm import LMParams

    torch.set_num_threads(4)
    state, _, cams, tables, plan, free, weights, huber = ot.synthetic_problem(
        n_poses=32, n_points=1024, n_objects=16, obs_per_point=6, obs_per_object=12, seed=0,
        dtype=np.float64, device="cpu")
    for objects in ("free", "fixed"):
        if objects == "fixed":
            free = T.FreeMasks(free.poses, free.points, torch.zeros_like(free.objects))
        _, s = lm_fused.solve(state, cams, tables, plan, free, weights, fixed(300), huber,
                              plain=True)
        _, d = lm_fused.solve(state, cams, tables, plan, free, weights, LMParams(), huber,
                              plain=True)
        print(f"objects {objects}: default stop {d.final_cost!r} {d.termination} after "
              f"{d.num_iterations} iterations; 300 iterations {s.final_cost!r} {s.termination}, "
              f"accepted share {np.mean([r.accepted for r in s.iterations]):.4f}")
        for m in (0, 5, 10, 15, 20, 30, 50, 100, 150, 200, 299):
            if m < len(s.iterations):
                r = s.iterations[m]
                print(f"  iteration {m}: cost {r.cost!r}, radius {r.radius:.3e}, accepted "
                      f"{r.accepted}, step {r.step_norm:.3e}")


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "crawl":
        crawl()
        return
    modes = {"gaps": gaps, "trajectory": trajectory, "same-length": same_length,
             "repeat": repeat}
    if mode not in modes:
        raise SystemExit(__doc__)
    import chip_smoke as cs

    cs.preconditions()
    cs.build()
    modes[mode](cs)
    print(cs.card_line())


if __name__ == "__main__":
    main()
