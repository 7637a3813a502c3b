"""The plain reference at a tiny size: its residuals, robust cost and
gradient equal the program's on every factor family (two cameras, Huber's
linear branch, excluded rows), its solver reaches the program's optimum,
its judgement reads 1 for an unmoved state, and its TF32 rounding, the
control of a cell whose program takes no TF32 path, fails that cell's first
step."""

import numpy as np
import pytest
import torch

from benchmark.reference import build, factors, geometry, lm
from benchmark.traffic import problem as gen

HUBER = dict(reproj=1.0, bbox=0.5, shape=10.0, relpose=1.0, ltm=1.0,
             invalid_ellipse_error=1e6)


def _rot(rng, scale):
    return geometry.exp_so3(torch.as_tensor(rng.normal(size=3) * scale)).numpy()


def tiny_problem(seed=4):
    """Every family, two cameras, random weights: (arrays, program's
    (state, cams, tables, weights))."""
    from obvi_slam_tpu_torch import types as T
    from obvi_slam_tpu_torch.solver.schur import FactorWeights

    rng = np.random.default_rng(seed)
    n_pose, n_pt, n_obj = 6, 30, 3
    poses = np.concatenate([np.arange(n_pose)[:, None] * [0.3, 0, 0] + rng.normal(size=(n_pose, 3)) * 0.05,
                            rng.normal(size=(n_pose, 3)) * 0.05], 1)
    points = np.stack([rng.uniform(-2, 4, n_pt), rng.uniform(-1, 1, n_pt),
                       rng.uniform(4, 9, n_pt)], 1)
    objects = np.concatenate([np.stack([rng.uniform(0, 2, n_obj), rng.uniform(-1, 1, n_obj),
                                        rng.uniform(6, 9, n_obj)], 1),
                              rng.uniform(-0.5, 0.5, (n_obj, 1)),
                              rng.uniform(0.5, 1.0, (n_obj, 3))], 1)
    ext_r = np.stack([np.eye(3), _rot(rng, 0.02)])
    ext_t = np.array([[0, 0, 0], [0.12, 0.01, 0.0]])
    n_rp = 80
    rp = dict(pose=rng.integers(0, n_pose, n_rp), point=rng.integers(0, n_pt, n_rp),
              cam=rng.integers(0, 2, n_rp))
    rp["obs"] = rng.normal(size=(n_rp, 2)) * 0.02
    rp["obs"][:5] += 0.5  # on Huber's linear branch
    rp["mult"] = np.full((n_rp, 2), 50.0)
    n_bb = 10
    bb = dict(obj=rng.integers(0, n_obj, n_bb), pose=rng.integers(0, n_pose, n_bb),
              cam=rng.integers(0, 2, n_bb))
    bb["corners"] = np.sort(rng.normal(size=(n_bb, 4)) * 0.05, axis=1)[:, [0, 3, 1, 2]]
    bb["sqrt_inf"] = np.eye(4) * 8.0 + rng.normal(size=(n_bb, 4, 4)) * 0.1
    sh = dict(obj=np.arange(n_obj), mean=rng.uniform(0.5, 1, (n_obj, 3)),
              sqrt_inf=np.broadcast_to(np.eye(3) * 4.0, (n_obj, 3, 3)).copy())
    rl = dict(before=np.arange(n_pose - 1), after=np.arange(1, n_pose),
              t=rng.normal(size=(n_pose - 1, 3)) * 0.3,
              r=np.stack([_rot(rng, 0.05) for _ in range(n_pose - 1)]),
              sqrt_inf=np.broadcast_to(np.diag([5.0] * 3 + [9.0] * 3), (n_pose - 1, 6, 6)).copy())
    lt = dict(obj=np.array([0, 2]), mean=objects[[0, 2]] + 0.05,
              sqrt_inf=np.broadcast_to(np.eye(7) * 3.0, (2, 7, 7)).copy())
    pp = dict(kind=np.array([0, 1, 2]), block=np.array([1, 4, 2]), param=np.array([0, 2, 5]),
              mean=np.array([0.1, 5.0, 0.7]), inv_std=np.array([10.0, 2.0, 3.0]))
    w = {f: (rng.uniform(size=n) > 0.2).astype(float)
         for f, n in (("reproj", n_rp), ("bbox", n_bb), ("shape", n_obj),
                      ("relpose", n_pose - 1), ("ltm", 2))}
    arrays = dict(poses=poses, points=points, objects=objects,
                  cam_r=np.swapaxes(ext_r, 1, 2),
                  cam_t=-np.einsum("nji,nj->ni", ext_r, ext_t))
    for fam, d in (("reproj", rp), ("bbox", bb), ("shape", sh), ("relpose", rl), ("ltm", lt),
                   ("prior", pp)):
        arrays.update({f"{fam}_{k}": v for k, v in d.items()})
        if fam in w:
            arrays[f"{fam}_w"] = w[fam]
    kw = dict(dtype=np.float64, device="cpu")
    cams = T.make_camera_bundle(ext_r, ext_t, [500.0] * 2, [500.0] * 2, [320.0] * 2,
                                [240.0] * 2, **kw)
    tables = T.FactorTables(
        reproj=T.make_reprojection_factors(rp["pose"], rp["point"], rp["cam"], rp["obs"],
                                           rp["mult"], **kw),
        bbox=T.make_bounding_box_factors(bb["obj"], bb["pose"], bb["cam"], bb["corners"],
                                         bb["sqrt_inf"], **kw),
        shape=T.make_shape_prior_factors(sh["obj"], sh["mean"], sh["sqrt_inf"], **kw),
        relpose=T.make_relative_pose_factors(rl["before"], rl["after"], rl["t"], rl["r"],
                                             rl["sqrt_inf"], **kw),
        ltm=T.make_ltm_prior_factors(lt["obj"], lt["mean"], lt["sqrt_inf"], **kw),
        param_prior=T.make_param_prior_factors(pp["kind"], pp["block"], pp["param"],
                                               pp["mean"], pp["inv_std"], **kw),
    )
    state = T.BAState(poses=torch.tensor(poses, requires_grad=True),
                      points=torch.tensor(points, requires_grad=True),
                      objects=torch.tensor(objects, requires_grad=True))
    weights = FactorWeights(*(torch.tensor(w[f]) for f in ("reproj", "bbox", "shape",
                                                           "relpose", "ltm")))
    return arrays, (state, cams, tables, weights)


def _program_cost(state, cams, tables, weights):
    from obvi_slam_tpu_torch.factors import residuals as fac

    return fac.total_cost(state, cams, tables, huber_reproj=HUBER["reproj"],
                          huber_bbox=HUBER["bbox"], huber_shape=HUBER["shape"],
                          huber_relpose=HUBER["relpose"], huber_ltm=HUBER["ltm"],
                          reproj_weight=weights.reproj, bbox_weight=weights.bbox,
                          shape_weight=weights.shape, relpose_weight=weights.relpose,
                          ltm_weight=weights.ltm)


def test_residuals_match_the_program():
    from obvi_slam_tpu_torch.factors import residuals as fac

    arrays, (state, cams, tables, _) = tiny_problem()
    prob = build.plain_problem(arrays, HUBER)
    theirs = fac.all_residuals(state, cams, tables)
    for fam in ("reproj", "bbox", "shape", "relpose", "ltm"):
        mine = factors.residuals(prob, fam, prob.state())
        np.testing.assert_allclose(mine.numpy(), theirs[fam].detach().numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=fam)
    np.testing.assert_allclose(factors._prior_values(prob, prob.state()).numpy(),
                               theirs["param_prior"].detach().numpy(), rtol=1e-12)


def test_cost_and_gradient_match_the_program():
    arrays, (state, cams, tables, weights) = tiny_problem()
    prob = build.plain_problem(arrays, HUBER)
    lin = factors.linearize(prob, prob.state())
    cost = _program_cost(state, cams, tables, weights)
    assert float(lin.cost) == pytest.approx(float(cost.detach()), rel=1e-12)
    g_pose, g_pt, g_obj = torch.autograd.grad(cost, [state.poses, state.points, state.objects])
    g_pose, g_obj, g_pt = prob.take(g_pose, g_obj, g_pt)
    np.testing.assert_allclose(lin.g_c.numpy(), torch.cat([g_pose.reshape(-1),
                                                           g_obj.reshape(-1)]).numpy(),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(lin.g_l.numpy(), g_pt.numpy(), rtol=1e-8, atol=1e-8)


def test_padding_is_dropped():
    arrays, _ = tiny_problem()
    padded = dict(arrays, poses=np.concatenate([arrays["poses"], np.ones((3, 6))]))
    for key in ("reproj_pose", "reproj_point", "reproj_cam", "reproj_obs", "reproj_mult",
                "reproj_w"):
        extra = np.zeros((4,) + np.shape(arrays[key])[1:], np.asarray(arrays[key]).dtype)
        padded[key] = np.concatenate([arrays[key], extra])
    padded["reproj_mask"] = np.arange(len(padded["reproj_pose"])) < len(arrays["reproj_pose"])
    a, b = build.plain_problem(arrays, HUBER), build.plain_problem(padded, HUBER)
    assert b.poses.shape == a.poses.shape
    assert float(factors.cost(a, a.state())) == float(factors.cost(b, b.state()))


def test_step_products_are_the_quadratic_model():
    arrays, _ = tiny_problem(seed=9)
    prob = build.plain_problem(arrays, HUBER)
    lin = factors.linearize(prob, prob.state())
    rng = np.random.default_rng(0)
    d_c = torch.as_tensor(rng.normal(size=lin.g_c.shape) * 1e-6)
    d_l = torch.as_tensor(rng.normal(size=lin.g_l.shape) * 1e-6)
    gd, _ = factors.step_products(prob, lin, d_c, d_l)
    x = prob.state()
    n = x[0].numel()
    moved = (x[0] + d_c[:n].reshape(x[0].shape), x[1] + d_c[n:].reshape(x[1].shape),
             x[2] + d_l)
    change = float(factors.cost(prob, moved)) - float(lin.cost)
    assert change == pytest.approx(float(gd), rel=1e-3)


def test_two_phase_reaches_the_program_optimum():
    from obvi_slam_tpu_torch import synthetic
    from obvi_slam_tpu_torch.solver.lm import LMParams
    from obvi_slam_tpu_torch.solver.lm_fused import solve_two_phase
    from obvi_slam_tpu_torch.solver.two_phase import TwoPhaseAux, TwoPhaseConfig

    sizes = dict(n_poses=32, n_points=256, n_objects=4)
    raw = gen.synthetic_problem(**sizes, seed=11)
    prob = build.plain_problem(raw, HUBER)
    settings = lm.LMSettings(max_iterations=60, function_tolerance=1e-12)
    x_ref, _, w2, _ = lm.two_phase(prob, lm.TwoPhaseSettings(), settings, settings,
                                   torch.zeros(4, dtype=torch.bool),
                                   prob.factors["shape"]["mask"])
    s0, _, cams, tables, plan, free, weights, huber = synthetic.synthetic_problem(
        **sizes, seed=11, device="cpu")
    aux = TwoPhaseAux(is_ltm_obj=torch.zeros(4, dtype=torch.bool), shape_live=tables.shape.mask)
    final, _, _ = solve_two_phase(s0, cams, tables, plan, free, weights, aux, LMParams(),
                                  LMParams(), huber, TwoPhaseConfig())
    program = prob.take(final.poses, final.objects, final.points)
    assert abs(lm.suboptimality(prob, program, x_ref, w2)) < 1e-4
    assert lm.suboptimality(prob, prob.state(), x_ref, w2) == pytest.approx(1.0)
    shifted = (program[0] + 0.01, program[1], program[2])
    assert lm.suboptimality(prob, shifted, x_ref, w2) > 1e-2


def test_pair_and_dense_schur_agree(monkeypatch):
    arrays, _ = tiny_problem(seed=2)
    prob = build.plain_problem(arrays, HUBER)
    lin = factors.linearize(prob, prob.state())
    dense = lm.schur_step(prob, lin, 1e3)
    monkeypatch.setattr(lm, "DENSE_W_LIMIT", 0)
    pairs = lm.schur_step(prob, lin, 1e3)
    for a, b in zip(dense, pairs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-12, -(1 + 3 * 2**-12), 0.0])
    assert factors.tf32(x).tolist() == [1.0, 1 + 2**-10, 1.0, -(1 + 2**-10), 0.0]
    r = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    t = factors.tf32(r)
    assert bool(((t - r).abs() <= r.abs() * 2**-11).all())
    assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())


def test_tf32_first_step_fails_where_float32_holds():
    """The control of a cell whose program takes no TF32 path: the
    reference's first step with its products' operands rounded to TF32 lies
    past the cell's limit, where the same step in float32 lies within it."""
    from benchmark import harness

    driver = harness.load_module(harness.BENCH_DIR / "drivers" / "gba.py", "driver_gba")
    workload = harness.load_json(harness.BENCH_DIR / "workloads" / "gba.band_1024.json")
    config = harness.load_json(harness.BENCH_DIR / "configs" / f"{workload['config']}.json")
    config.update(n_poses=96, n_points=1024, n_objects=4)
    limit = workload["limits"]["first_step_norm"]
    settings = driver.program_settings(config)
    for seed in (1, 2):
        raw = driver.make_problem(workload, config, seed)
        ref = build.plain_problem(raw, config["huber"], dtype=torch.float64)
        low = build.plain_problem(raw, config["huber"], dtype=torch.float32)
        norm_ref = lm.first_step(ref, ref.state(), None, settings)[2]
        assert lm.norm_gap(lm.first_step(low, low.state(), None, settings)[2], norm_ref) < limit
        factors.operand_rounding = factors.tf32
        try:
            norm = lm.first_step(low, low.state(), None, settings)[2]
        finally:
            factors.operand_rounding = None
        assert lm.norm_gap(norm, norm_ref) > limit
