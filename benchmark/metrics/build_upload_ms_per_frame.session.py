"""Host ms per window frame in the problem builds' host-to-device copies
(window BA, PGO, tracking, feature adjustment and the mini-BAs): the
program's span ``problem_build_upload`` over the window's frames; nothing
where the program has no such span."""


def read(record):
    if not record.get("frames") or "problem_build_upload" not in record["timers"]:
        return None
    return record["timers"]["problem_build_upload"] * 1e3 / record["frames"]
