"""Host ms per window frame in the bounding-box frontend (association and
its pending-object mini-BAs): the program's cumulative timer
``bb_front_end_add_bb_obs`` over the window's frames."""


def read(record):
    if not record.get("frames"):
        return None
    return record["timers"].get("bb_front_end_add_bb_obs", 0.0) * 1e3 / record["frames"]
