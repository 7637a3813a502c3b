"""Host ms per window frame in PGO (tracking, pose graph with ellipsoids,
feature adjustment) on global-BA frames: the program's timer
``obj_only_pgo_full_process`` over the window's frames."""


def read(record):
    if not record.get("frames"):
        return None
    return record["timers"].get("obj_only_pgo_full_process", 0.0) * 1e3 / record["frames"]
