"""Host ms per window frame that no stage span of the program explains: the
frame (timer ``optimization_iteration``) less its disjoint top-level
stages (the frame's pose, the visual frontend, the box frontend's hook,
PGO, the window or global BA). Nothing where the program has no stage
spans."""

STAGES = ("frame_pose_add", "visual_frontend_add_obs", "bb_frontend_hook",
          "obj_only_pgo_full_process", "local_bundle_adjustment", "global_bundle_adjustment")


def read(record):
    if not record.get("frames"):
        return None
    timers = record["timers"]
    if "frame_pose_add" not in timers or "optimization_iteration" not in timers:
        return None
    other = timers["optimization_iteration"] - sum(timers.get(k, 0.0) for k in STAGES)
    return other * 1e3 / record["frames"]
