"""Host ms of the window in the long-term map's far-feature filter (the
host's loops over every feature's observations and the zeroed weights):
the program's span ``ltm_far_features``; nothing where the program has no
such span."""


def read(record):
    if not record.get("frames") or "ltm_far_features" not in record["timers"]:
        return None
    return record["timers"]["ltm_far_features"] * 1e3
