"""Host ms per window frame in the visual frontend (feature association and
its epipolar and parallax checks): the program's span
``visual_frontend_add_obs`` over the window's frames; nothing where the
program has no such span."""


def read(record):
    if not record.get("frames") or "visual_frontend_add_obs" not in record["timers"]:
        return None
    return record["timers"]["visual_frontend_add_obs"] * 1e3 / record["frames"]
