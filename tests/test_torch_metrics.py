"""obvi_slam_tpu_torch.metrics against obvi_slam_tpu.metrics: trajectory
alignment, ATE, RPE, waypoint consistency, object association, IoU and
object metrics on seeded random trajectories and ellipsoids (rtol 1e-12),
and the reference metric-file schema written byte for byte alike."""

import dataclasses

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import obvi_slam_tpu.metrics as JM
from obvi_slam_tpu.metrics import schema as JS
import obvi_slam_tpu_torch.metrics as PM
from obvi_slam_tpu_torch.metrics import schema as PS

RTOL = 1e-12


def assert_close_tree(a, b, path="result"):
    """Equal structure; floats and arrays within RTOL; the rest equal."""
    if dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, path
        assert_close_tree(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            assert_close_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close_tree(x, y, f"{path}[{i}]")
    elif isinstance(b, (float, np.floating, np.ndarray)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=path)
    else:
        assert a == b, (path, a, b)


def random_trajectory(rng, n):
    t = np.zeros((n, 6))
    t[:, 0] = np.cumsum(rng.uniform(0.1, 0.5, n))
    t[:, 1] = np.sin(np.arange(n) * 0.3) + rng.normal(size=n) * 0.05
    t[:, 3:] = rng.normal(size=(n, 3)) * 0.2
    return t


def perturbed(rng, traj, lost=()):
    """``traj`` moved by a rigid transform plus noise, with NaN rows at
    ``lost``."""
    rot = Rotation.from_euler("zyx", rng.normal(size=3) * 0.5).as_matrix()
    shift = rng.normal(size=3)
    out = traj.copy()
    for i, p in enumerate(traj):
        r = Rotation.from_rotvec(p[3:]).as_matrix()
        out[i, :3] = rot @ p[:3] + shift + rng.normal(size=3) * 0.05
        out[i, 3:] = Rotation.from_matrix(rot @ r).as_rotvec() + rng.normal(size=3) * 0.01
    out[list(lost)] = np.nan
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trajectory_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    gt = random_trajectory(rng, 40)
    est = perturbed(rng, gt, lost=(3, 17) if seed else ())
    assert_close_tree(PM.find_alignment_transformation(est, gt),
                      JM.find_alignment_transformation(est, gt), "alignment")
    aligned_p = PM.align_with_ground_truth(gt, est)
    aligned_j = JM.align_with_ground_truth(gt, est)
    np.testing.assert_allclose(aligned_p, aligned_j, rtol=RTOL, atol=1e-14)
    results = {}
    for name in ("ate_for_synced_aligned", "rpe_for_synced_aligned"):
        ours, ref = getattr(PM, name)(aligned_p, gt), getattr(JM, name)(aligned_j, gt)
        assert_close_tree(ours, ref, name)
        results[name] = (ours, ref)
    ate_p, ate_j = results["ate_for_synced_aligned"]
    assert_close_tree(PM.combine_ate_results([ate_p, ate_p]),
                      JM.combine_ate_results([ate_j, ate_j]), "combine")
    vals = rng.exponential(size=25)
    assert_close_tree(PM.distribution_stats(vals), JM.distribution_stats(vals), "stats")


def test_waypoint_consistency_matches_jax():
    rng = np.random.default_rng(5)
    visits = {
        wp: [[np.concatenate([rng.normal(size=3), rng.normal(size=3) * 0.3])
               for _ in range(rng.integers(1, 4))] for _ in range(3)]
        for wp in range(6)
    }
    assert_close_tree(PM.waypoint_consistency(visits), JM.waypoint_consistency(visits))


def random_objects(rng, n, classes=("chair", "table")):
    return {
        k: (classes[int(rng.integers(len(classes)))],
            np.concatenate([rng.uniform(-5, 5, 3), [rng.uniform(-np.pi, np.pi)],
                            rng.uniform(0.3, 1.5, 3)]))
        for k in range(n)
    }


def jittered(rng, objects, drop=1, extra=2):
    out = {}
    for k, (cls, e) in list(objects.items())[drop:]:
        out[100 + k] = (cls, e + np.concatenate([rng.normal(size=3) * 0.2,
                                                [rng.normal() * 0.1], rng.normal(size=3) * 0.05]))
    out.update({200 + k: v for k, v in random_objects(rng, extra).items()})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_object_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    gt = random_objects(rng, 6)
    est = jittered(rng, gt)
    for one_to_one in (True, False):
        assert PM.associate_objects(est, gt, one_to_one, 3.0) == JM.associate_objects(
            est, gt, one_to_one, 3.0)
    e = gt[0][1]
    assert_close_tree(PM.ellipsoid_aabb(e), JM.ellipsoid_aabb(e), "aabb")
    others = [v[1] for v in est.values()][:3]
    assert_close_tree(PM.iou_for_object_set(e, others, samples_per_dim=12),
                      JM.iou_for_object_set(e, others, samples_per_dim=12), "iou")
    assert_close_tree(PM.object_metrics(est, gt, max_assoc_dist=3.0),
                      JM.object_metrics(est, gt, max_assoc_dist=3.0), "object_metrics")


def test_schema_files_byte_equal(tmp_path):
    """Both packages write the same metric files, and each reads the
    other's."""
    rng = np.random.default_rng(7)
    gt = random_trajectory(rng, 30)
    est = perturbed(rng, gt, lost=(4,))
    texts = {}
    for name, M, S in (("ours", PM, PS), ("ref", JM, JS)):
        aligned = M.align_with_ground_truth(gt, est)
        ate, rpe = M.ate_for_synced_aligned(aligned, gt), M.rpe_for_synced_aligned(aligned, gt)
        traj = S.trajectory_metrics_to_ref_json(
            ate, rpe=rpe, waypoint_deviations={"3": {"transl": [0.1], "rot": [0.01]}},
            all_translation_deviations=[0.1, 0.2], all_rotation_deviations=[0.01])
        S.write_metrics_file(str(tmp_path / f"{name}_traj.json"), traj, [traj, traj])
        objs = random_objects(np.random.default_rng(8), 5)
        m = M.object_metrics(jittered(np.random.default_rng(9), objs), objs,
                             max_assoc_dist=3.0)
        S.write_object_metrics_file(str(tmp_path / f"{name}_obj.json"),
                                    [S.object_metrics_to_ref_json(m)])
        texts[name] = [(tmp_path / f"{name}_{k}.json").read_bytes() for k in ("traj", "obj")]
    assert texts["ours"] == texts["ref"]
    for reader, other in ((PS, "ref"), (JS, "ours")):
        seq, indiv = reader.read_metrics_file(str(tmp_path / f"{other}_traj.json"))
        assert len(indiv) == 2
        assert reader.read_object_metrics_file(str(tmp_path / f"{other}_obj.json"))
    assert_close_tree(PS.read_metrics_file(str(tmp_path / "ref_traj.json")),
                      JS.read_metrics_file(str(tmp_path / "ref_traj.json")), "read")
