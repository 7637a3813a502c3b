"""Device ms per LM iteration of the traced solves: the union of the device
operations' intervals over the iterations of both phases (graph replays
past a solve's end included, as they occupy the device)."""


def read(record):
    trace, n = record.get("trace"), record.get("traced_iterations")
    if not trace or not n or trace["busy_s"] <= 0:
        return None
    return trace["busy_s"] * 1e3 / n
