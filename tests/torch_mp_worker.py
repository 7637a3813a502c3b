"""One gloo rank of a job that ``tests/torch_mp.py`` launches:

    python tests/torch_mp_worker.py <job> <rank> <ranks> <port> <dir>

The rank joins the others through ``parallel.initialize_distributed`` at
localhost:<port> on the CPU, runs ``JOBS[job]`` on the inputs the test wrote
to ``<dir>/inputs.pt`` and saves what it returns to ``<dir>/rank<r>.pt``.
Imports torch and the port only."""

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
    pg = ot.PoseGraph(data.cameras)
    assert runner.run_optimization(data, pg, visual_frontend=visual_frontend_for(runner, data))
    ilf.write_all()
    optlog.IterationLoggerFactory.reset()
    n = data.max_frame_id() + 1
    return dict(poses=np.stack([pg.get_robot_pose(i) for i in range(n)]),
                opt_log=[(r.frame_id, r.phase, r.final_cost, r.iterations)
                         for r in runner.opt_log],
                checkpoints=checkpoints)


JOBS = {"dd_solve": job_dd_solve, "step": job_step, "runner": job_runner}


def main(job, rank, n, port, out):
    par.initialize_distributed(f"localhost:{port}", int(n), int(rank), device="cpu")
    mesh = par.make_mesh(device="cpu")
    out = Path(out)
    inputs = torch.load(out / "inputs.pt", weights_only=False)
    result = JOBS[job](mesh, inputs)
    torch.save(result, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:6])
