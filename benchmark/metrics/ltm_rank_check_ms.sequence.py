"""Host ms of the window in the long-term map's rank check (the host's
float64 eigendecomposition of the reduced system and the repair's priors):
the program's span ``ltm_rank_check``; nothing where the program has no
such span."""


def read(record):
    if not record.get("frames") or "ltm_rank_check" not in record["timers"]:
        return None
    return record["timers"]["ltm_rank_check"] * 1e3
