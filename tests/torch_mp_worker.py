"""One gloo rank of a job that ``tests/torch_mp.py`` launches:

    python tests/torch_mp_worker.py <job> <rank> <ranks> <port> <dir> [<seconds>]

The rank joins the others through ``parallel.initialize_distributed`` at
localhost:<port> on the CPU, runs ``JOBS[job]`` on the inputs the test wrote
to ``<dir>/inputs.pt`` and saves what it returns to ``<dir>/rank<r>.pt``.
With ``<seconds>`` (the launcher's deadline) the rank dumps every thread's
stack into its log shortly before it, so that a slow or stuck rank shows
where it is. Imports torch and the port only."""

import faulthandler
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

torch.set_num_threads(1)

from obvi_slam_tpu_torch import parallel as par  # noqa: E402
from obvi_slam_tpu_torch.parallel import audit  # noqa: E402
from obvi_slam_tpu_torch.solver import band_solve, lm_fused  # noqa: E402
from obvi_slam_tpu_torch.solver import schur as schur_mod  # noqa: E402

def job_dd_solve(mesh, inputs):
    """dd_woodbury_band_solve with one domain per rank on each case."""
    out = {}
    for name, c in inputs.items():
        with audit.recording() as rec:
            x, ok = band_solve.dd_woodbury_band_solve(
                c.get("d"), c.get("e"), c["z"], c["rhs"], n_domains=mesh.size, mesh=mesh,
                rel_scatter=c.get("rel_scatter"), gram_quads=c.get("gram_quads"))
        out[name] = dict(x=x, ok=bool(ok), collectives=audit.collect_collectives(rec))
    return out


def job_step(mesh, inputs):
    """compute_step (and, where asked, solve_two_phase) on this rank's shard
    of each case's problem."""
    out = {}
    for name, c in inputs.items():
        state, cams, tables, plan, free, weights, radius, huber = c["args"]
        sh_tables = par.shard_tables(tables, mesh)
        sh_plan = par.shard_plan(plan, mesh)
        sh_weights = par.shard_weights(weights, mesh)
        schur_mod.reset_path_counts()
        with audit.recording() as rec:
            delta, mc, gm = par.sharded_compute_step(mesh)(
                state, cams, sh_tables, sh_plan, free, sh_weights, radius, huber,
                plain=True, **c.get("kwargs", {}))
        res = dict(delta=delta, mc=mc, gm=gm, collectives=audit.collect_collectives(rec),
                   paths=dict(schur_mod.path_counts))
        if "two_phase" in c:
            aux, p1, p2, tp_cfg = c["two_phase"]
            final, s1, s2 = lm_fused.solve_two_phase(
                state, cams, sh_tables, sh_plan, free, sh_weights,
                par.sharding.shard_aux(aux, tables, mesh), p1, p2, huber, tp_cfg,
                plain=True, mesh=mesh)
            res["two_phase"] = dict(final=final, costs=[
                (s.initial_cost, s.final_cost, s.num_iterations) for s in (s1, s2)])
        out[name] = res
    return out


def job_runner(mesh, inputs):
    """The session of ``inputs`` through OfflineProblemRunner on the mesh;
    checkpoints counted, optimization logs written under ``inputs["logs"]``."""
    import numpy as np

    import obvi_slam_tpu_torch as ot
    from obvi_slam_tpu_torch import optlog
    from obvi_slam_tpu_torch.runner import visual_frontend_for

    checkpoints = []
    hooks = ot.runner.RunnerHooks(checkpoint=lambda pg, label: checkpoints.append(label))
    ilf = optlog.IterationLoggerFactory.instance()
    ilf.set_logging_directory(f"{inputs['logs']}/rank{mesh.rank}")
    data, _, _ = ot.synthetic_session(**inputs["session"])
    runner = ot.OfflineProblemRunner(
        ot.config.read_config(inputs["config"]), hooks, device="cpu", mesh=mesh,
        shard_local_ba=inputs["shard_local_ba"],
        use_fused_solver=inputs.get("use_fused_solver"))
    pools = []  # (key, pool before the build) of every build
    build = runner._build_problem

    def record(pg_, scope, key, **kw):
        pools.append((key, dict(runner.caps_pool(key))))
        return build(pg_, scope, key, **kw)

    runner._build_problem = record
    pg = ot.PoseGraph(data.cameras)
    assert runner.run_optimization(data, pg, visual_frontend=visual_frontend_for(runner, data))
    ilf.write_all()
    optlog.IterationLoggerFactory.reset()
    n = data.max_frame_id() + 1
    return dict(poses=np.stack([pg.get_robot_pose(i) for i in range(n)]),
                opt_log=[(r.frame_id, r.phase, r.final_cost, r.iterations)
                         for r in runner.opt_log],
                checkpoints=checkpoints, pools=pools)


def perturb_mini_ba(delta):
    """Adds ``delta`` to every object that the frontend's pending-object
    mini-BA returns in this process."""
    from obvi_slam_tpu_torch.frontend import bounding_box_frontend as bbf

    inner = bbf.solve

    def solve(*args, **kwargs):
        state, summary = inner(*args, **kwargs)
        return state._replace(objects=state.objects + delta), summary

    bbf.solve = solve


def frontend_run(inputs, mesh=None):
    """The bounding-box frontend alone over ``inputs["session"]``'s object
    session, every frame at its ground-truth pose (no runner), its mini-BA
    estimates decided on ``mesh``'s rank 0 when given."""
    import obvi_slam_tpu_torch as ot
    from obvi_slam_tpu_torch.frontend import FeatureBasedBoundingBoxFrontEnd, make_bb_frontend_hook

    data, gt, _ = ot.synthetic_object_session(**inputs["session"])
    config = ot.config.read_config(inputs["config"])
    pg = ot.PoseGraph(data.cameras, ot.config.shape_prior_map(config))
    fe = FeatureBasedBoundingBoxFrontEnd(
        pg, config.feature_based_bb_association_params,
        config.bounding_box_covariance_generator_params,
        config.geometric_similarity_scorer_params, img_heights_and_widths={1: (480.0, 640.0)},
        device="cpu", mesh=mesh)
    hook = make_bb_frontend_hook(fe)
    for frame in range(len(gt)):
        pg.add_frame(frame, gt[frame])
        hook(data, pg, frame)
    return dict(objects={o: n.ellipsoid for o, n in pg.objects.items()},
                observations=[(f.object_id, f.frame_id) for f in pg.object_observations],
                pending=[p.object_estimate for p in fe.pending],
                differences=list(fe.rank_differences))


def job_frontend(mesh, inputs):
    """``frontend_run`` with rank 1's mini-BA results perturbed by
    ``inputs["perturb"]``, on the mesh unless ``inputs["agree"]`` is
    False."""
    if mesh.rank == 1:
        perturb_mini_ba(inputs["perturb"])
    return frontend_run(inputs, mesh if inputs["agree"] else None)


def job_frontend_session(mesh, inputs):
    """The main CLI's session on ``inputs["argv"]`` (which holds
    ``--shard_devices``), built by its ``build_session`` on this process
    group, with rank 1's mini-BA results perturbed by
    ``inputs["perturb"]``."""
    from obvi_slam_tpu_torch.cli import offline_object_visual_slam_main as cli_main

    cli_main.parallel.initialize_distributed = lambda **kwargs: True  # joined already
    if mesh.rank == 1:
        perturb_mini_ba(inputs["perturb"])
    session = cli_main.build_session(cli_main.parse_args(inputs["argv"]))
    assert cli_main.run_session(session)
    return dict(state=session.pg.get_state(),
                pending=[p.object_estimate for p in session.bb_frontend.pending],
                differences=list(session.bb_frontend.rank_differences),
                opt_log=[(r.frame_id, r.phase, r.final_cost, r.iterations)
                         for r in session.runner.opt_log])


JOBS = {"dd_solve": job_dd_solve, "step": job_step, "runner": job_runner,
        "frontend": job_frontend, "frontend_session": job_frontend_session}


# How long before the launcher's deadline a rank dumps its stacks.
DUMP_MARGIN = 10.0


def main(job, rank, n, port, out, seconds=None):
    if seconds is not None:
        faulthandler.dump_traceback_later(max(float(seconds) - DUMP_MARGIN, 1.0), exit=False)
    par.initialize_distributed(f"localhost:{port}", int(n), int(rank), device="cpu")
    mesh = par.make_mesh(device="cpu")
    out = Path(out)
    inputs = torch.load(out / "inputs.pt", weights_only=False)
    result = JOBS[job](mesh, inputs)
    torch.save(result, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:7])
