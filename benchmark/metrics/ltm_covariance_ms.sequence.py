"""Host ms of the window in the long-term map's marginal covariances (each
call of the program on the card, the repair's retry too, with its
read-back): the program's span ``ltm_covariance``; nothing where the
program has no such span."""


def read(record):
    if not record.get("frames") or "ltm_covariance" not in record["timers"]:
        return None
    return record["timers"]["ltm_covariance"] * 1e3
