"""Host ms per window frame blocked on the card: the program's span
``host_wait_on_device`` (every blocking read of device memory by the host:
the fused solves' running flag and summaries, write-backs, mini-BA
results) over the window's frames; the rest of a frame is the host's own
work. Nothing where the program has no such span."""


def read(record):
    if not record.get("frames") or "host_wait_on_device" not in record["timers"]:
        return None
    return record["timers"]["host_wait_on_device"] * 1e3 / record["frames"]
